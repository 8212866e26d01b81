"""Incremental parameter push: a dense snapshot plus the touched rows of the
id tables. The port of the JAX package's ``serving/param_push.py``.

A training minute changes the whole dense trunk (small) but only the table
rows whose ids appeared in its batches (the touched-row sparse update moves
no other row). So a push is exact as a delta: track the touched ids on the
host as the batches go by, gather those rows, and ship {dense snapshot,
per-table (ids, rows)}. An engine that started from the same base
checkpoint applies it and holds the trainer's parameters bit for bit.

Everything is keyed by state-dict name. The id tables are the names
``convert.table_param_names`` gives (``tokenizer.embeds.<feature>.weight``,
``tokenizer.item_embed.weight``; ``table_keys`` is that function); every
other name is dense. ``build_push`` takes the tables from the tracker's
snapshot, and the receiver's side names them (``tables``).

    tracker = PushTracker(cfg)
    trainer.train(tracker.wrap(batches), ...)       # observe ids on the host
    push = build_push(state.params, tracker.snapshot(), step=state.step)
    save_push(push, "push_000120.npz")
    engine.apply_push(load_push("push_000120.npz", engine.state_dict(),
                                table_keys(cfg)))

Unlike the JAX module, ``apply_push`` validates the whole push (names,
shapes, dtypes, ids < V) before it builds anything, and builds the new
tables out of place, so a malformed push leaves the caller's tensors as
they were (the engine's ``apply_push`` validates the same way, then writes
into its own tensors); ``load_push`` holds the stored push against the
receiver the same way and raises on a mismatch. Nothing is compiled, so
nothing is rebuilt per call.

The wire format is a flat ``.npz``: ``step``, ``dense::<name>``,
``ids::<name>`` and ``rows::<name>``. numpy has no bfloat16, so bf16 rows
travel as their int16 bits, listed under ``__bf16__``.
"""

from __future__ import annotations

import io
import os
from typing import Collection, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import table_param_names

Tensors = Mapping[str, torch.Tensor]
table_keys = table_param_names


class PushTracker:
    """Host-side touched-id tracking. ``wrap`` an iterator of numpy
    batches: marking is numpy indexing on arrays the pipeline made anyway,
    so the training step pays no device work."""

    def __init__(self, cfg: RankingConfig):
        self.cfg = cfg
        names = table_param_names(cfg)
        self._ns = dict(zip(cfg.non_seq_features, names))  # feature -> its table
        self._masks: Dict[str, np.ndarray] = {
            name: np.zeros(cfg.vocab_size(f) + 1, bool) for f, name in self._ns.items()}
        self._item = names[-1] if cfg.sequence_features else None
        if self._item:
            self._masks[self._item] = np.zeros(cfg.vocab_size("item_id") + 1, bool)

    def observe(self, batch: Dict) -> None:
        for f, name in self._ns.items():
            self._masks[name][np.asarray(batch["non_seq"][f]).ravel()] = True
        item = self._masks.get(self._item)
        for sf, arr in batch.get("sequences", {}).items():
            ids = np.asarray(arr)[np.asarray(batch["seq_valid"][sf])]
            if ids.size:
                item[ids] = True

    def wrap(self, batches: Iterable[Dict]) -> Iterator[Dict]:
        for b in batches:
            self.observe(b)
            yield b

    def snapshot(self, reset: bool = True) -> Dict[str, np.ndarray]:
        """{table name: sorted touched ids}; ``reset`` starts the next
        window (take it when the pushed params are read)."""
        out = {k: np.flatnonzero(m) for k, m in self._masks.items()}
        if reset:
            for m in self._masks.values():
                m[:] = False
        return out


@torch.no_grad()
def build_push(params: Tensors, touched: Mapping[str, np.ndarray], step: int = 0,
               rows_dtype: Optional[torch.dtype] = None) -> Dict:
    """The delta: every dense tensor whole, and (ids, rows) of each table
    with touched ids, on the host. The tables are ``touched``'s keys (a
    ``PushTracker.snapshot``: every table, touched or not). Only the touched
    rows leave the device. ``rows_dtype`` (e.g. ``torch.bfloat16``) halves
    the rows' bytes at about three decimals; None keeps the push exact."""
    dense = {k: v.detach().cpu().clone() for k, v in params.items() if k not in touched}
    tables = {}
    for k, ids in touched.items():
        if k not in params or len(ids) == 0:
            continue
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64))
        rows = params[k].detach()[idx.to(params[k].device)]
        if rows_dtype is not None:
            rows = rows.to(rows_dtype)
        tables[k] = {"ids": idx, "rows": rows.cpu()}
    return {"step": int(step), "dense": dense, "tables": tables}


def validate(params: Tensors, push: Dict, tables: Collection[str]) -> None:
    """Raise unless ``push`` fits ``params``, whose id tables are
    ``tables``: the dense names are exactly the receiver's other names, with
    its shapes and dtypes; each pushed table is one of ``tables``, its rows
    as wide, its ids 1-D integers in [0, V), one per row."""
    dense_names = {k for k in params if k not in tables}
    got = set(push["dense"])
    if got != dense_names:
        raise ValueError(f"push dense names differ: missing {sorted(dense_names - got)}, "
                         f"unknown {sorted(got - dense_names)}")
    for k, v in push["dense"].items():
        ref = params[k]
        if tuple(v.shape) != tuple(ref.shape) or v.dtype != ref.dtype:
            raise ValueError(f"push {k}: {tuple(v.shape)} {v.dtype}, receiver "
                             f"{tuple(ref.shape)} {ref.dtype}")
    for k, d in push["tables"].items():
        if k not in params or k not in tables:
            raise ValueError(f"push table {k!r} is not a table of the receiver")
        table, ids, rows = params[k], d["ids"], d["rows"]
        if ids.dim() != 1 or ids.dtype.is_floating_point or ids.dtype == torch.bool:
            raise ValueError(f"push {k}: ids must be a 1-D integer tensor")
        if rows.dim() != 2 or rows.shape[0] != ids.shape[0] or rows.shape[1] != table.shape[1]:
            raise ValueError(f"push {k}: rows {tuple(rows.shape)} for {ids.shape[0]} ids, "
                             f"table {tuple(table.shape)}")
        if not rows.dtype.is_floating_point:
            raise ValueError(f"push {k}: rows of dtype {rows.dtype}")
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= table.shape[0]):
            raise ValueError(f"push {k}: ids outside [0, {table.shape[0]})")


@torch.no_grad()
def apply_push(params: Tensors, push: Dict, tables: Collection[str]) -> Dict[str, torch.Tensor]:
    """A new state dict: the pushed dense tensors, and each pushed table a
    copy of the receiver's with the pushed rows written in (``tables``: the
    receiver's id tables, ``table_keys(cfg)``). The receiver's tensors are
    not touched; the whole push is validated first. Exact when ``params`` is
    the checkpoint the delta was accumulated from."""
    validate(params, push, tables)
    out = {}
    for k, ref in params.items():
        if k not in tables:
            out[k] = push["dense"][k].to(ref.device)
        elif k in push["tables"]:
            d = push["tables"][k]
            out[k] = ref.detach().clone().index_copy_(
                0, d["ids"].to(ref.device, torch.long), d["rows"].to(ref.device, ref.dtype))
        else:
            out[k] = ref
    return out


def push_nbytes(push: Dict) -> int:
    tensors = list(push["dense"].values())
    tensors += [t for d in push["tables"].values() for t in (d["ids"], d["rows"])]
    return sum(t.numel() * t.element_size() for t in tensors)


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save_push(push: Dict, path: str) -> int:
    """Write the flat ``.npz`` (renamed into place, so a reader never sees
    a torn file); returns the bytes written."""
    flat = {"step": np.asarray(push["step"])}
    bf16 = []
    for k, v in push["dense"].items():
        flat[f"dense::{k}"] = _np(v)
        if v.dtype == torch.bfloat16:
            bf16.append(f"dense::{k}")
    for k, d in push["tables"].items():
        flat[f"ids::{k}"] = d["ids"].numpy()
        flat[f"rows::{k}"] = _np(d["rows"])
        if d["rows"].dtype == torch.bfloat16:
            bf16.append(f"rows::{k}")
    flat["__bf16__"] = np.asarray(bf16, dtype=str)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    data = buf.getvalue()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return len(data)


def load_push(path: str, params_like: Tensors, tables: Collection[str]) -> Dict:
    """Read a ``save_push`` file for a receiver holding ``params_like`` (any
    state dict of the target model: the engine's own will do), whose id
    tables are ``tables``. The stored push must fit it as ``apply_push``
    requires (names, shapes, dtypes, ids); otherwise it raises."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    bf16 = set(arrays.pop("__bf16__").tolist())

    def tensor(key):
        t = torch.from_numpy(arrays[key])
        return t.view(torch.bfloat16) if key in bf16 else t

    dense = {k[len("dense::"):]: tensor(k) for k in arrays if k.startswith("dense::")}
    pushed = {k[len("ids::"):]: {"ids": tensor(k), "rows": tensor("rows::" + k[len("ids::"):])}
              for k in arrays if k.startswith("ids::")}
    push = {"step": int(arrays["step"]), "dense": dense, "tables": pushed}
    validate(params_like, push, tables)
    return push
