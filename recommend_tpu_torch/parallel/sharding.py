"""Partition rules: parameters, optimizer state and batches -> each rank's
block. The port of the JAX package's ``parallel/sharding.py``.

The rules are JAX's, on the port's state-dict names:

- an embedding table (the ``weight`` of an ``nn.Embedding``: the ranking
  tokenizer's ``embeds.<feature>`` and ``item_embed``, the retrieval
  tower's ``embed.tables.<feature>``) of at least ``ROW_SHARD_MIN_VOCAB``
  rows is row-sharded over ``model``, ``("model", None)``;
- a dedicated NS stack (``q_ns``, ``k_ns``, ... ``[n_ns, ...]``) is sharded
  over ``model`` on its stack axis when the axis divides, ``("model",)``;
- everything else is replicated, ``()``;
- a batch is split on its leading dim over ``data``, ``("data",)``.

A spec is the tuple of a ``PartitionSpec``. Every sharded tensor is split
on dim 0 into contiguous blocks, rank i of the axis holding block i, as
``device_put`` with a ``NamedSharding`` places them. An optimizer state
keyed by parameter name (moments, accumulators) is split as its parameter;
``accum_sharding`` gives a sparse-update accumulator its table's rows.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# row-shard only tables at least this many rows (small tables stay replicated)
ROW_SHARD_MIN_VOCAB = 16_384

# dedicated NS stacks worth sharding over 'model' (leaf names from MixedBlock)
_NS_STACK_NAMES = {
    "q_ns", "k_ns", "v_ns", "ffn_ns_in", "ffn_ns_out", "ffn_ns_in_b", "ffn_ns_out_b",
}

_TABLE = re.compile(r"(^|\.)(embeds\.[^.]+|item_embed|tables\.[^.]+)\.weight$")

Spec = Tuple
REPLICATED: Spec = ()
ROWS: Spec = ("model", None)
STACK: Spec = ("model",)


def is_table(name: str) -> bool:
    return bool(_TABLE.search(name))


def param_spec(name: str, tensor: torch.Tensor, model_axis_size: int) -> Spec:
    if is_table(name) and tensor.ndim == 2:
        if tensor.shape[0] >= ROW_SHARD_MIN_VOCAB and model_axis_size > 1:
            return ROWS
        return REPLICATED
    if (model_axis_size > 1 and name.rsplit(".", 1)[-1] in _NS_STACK_NAMES
            and tensor.shape[0] % model_axis_size == 0):
        return STACK
    return REPLICATED


def param_shardings(mesh, params: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    m = mesh.shape["model"]
    return {n: param_spec(n, t, m) for n, t in params.items()}


def model_sharded(mesh, params: Mapping[str, torch.Tensor]) -> frozenset:
    """The names of ``params`` split over ``model``."""
    return frozenset(n for n, s in param_shardings(mesh, params).items() if s)


def block(x, n: int, i: int):
    """Block ``i`` of ``n`` of dim 0 (a tensor or a numpy array)."""
    rows = x.shape[0]
    assert rows % n == 0, f"{rows} rows do not split into {n} blocks"
    b = rows // n
    return x[i * b:(i + 1) * b]


def _split(mesh, t: torch.Tensor) -> torch.Tensor:
    return block(t, mesh.shape["model"], mesh.rank("model")).clone()


def shard_params(mesh, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's block of the full ``params``, on the mesh's device (the
    counterpart of ``device_put(params, param_shardings(mesh, params))``)."""
    sharded = model_sharded(mesh, params)
    out = {}
    for n, t in params.items():
        t = torch.as_tensor(t).to(mesh.device)
        out[n] = _split(mesh, t) if n in sharded else t
    return out


def gather_params(mesh, params: Mapping[str, torch.Tensor],
                  sharded: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The full tensors of ``params`` from every rank's blocks; ``sharded``:
    the names split over ``model`` (``model_sharded`` of the full ones)."""
    sharded = set(sharded)
    return {n: _gather_model(mesh, t) if n in sharded else t for n, t in params.items()}


def _gather_model(mesh, t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return mesh.all_gather(t.detach(), "model")


def map_state(state: Any, names: Iterable[str], fn) -> Any:
    """``state`` (nested dicts, tuples and lists) with ``fn`` applied to
    each tensor stored under a key in ``names``."""
    names = set(names)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, torch.Tensor) and key in names:
            return fn(x)
        return x

    return walk(state)


def shard_state(mesh, state: Any, sharded: Iterable[str]) -> Any:
    """An optimizer state keyed by parameter name, each tensor of a sharded
    name replaced by this rank's block."""
    return map_state(state, sharded, lambda t: _split(mesh, t))


def gather_state(mesh, state: Any, sharded: Iterable[str]) -> Any:
    """The inverse of ``shard_state``."""
    return map_state(state, sharded, lambda t: _gather_model(mesh, t))


def global_norm(mesh, grads: Mapping[str, torch.Tensor], sharded: Iterable[str] = ()):
    """sqrt of the sum of squares of the full tensors whose blocks ``grads``
    holds: one float32 sum per tensor, those of ``sharded`` names summed
    over ``model`` too, then their sum (``optimizer.global_norm``'s order
    when nothing is sharded)."""
    sq = torch.stack([g.float().square().sum() for g in grads.values()])
    sharded = set(sharded)
    split = [n in sharded for n in grads]
    if mesh is not None and any(split):
        mask = torch.tensor(split, device=sq.device)
        part = mesh.all_reduce_(torch.where(mask, sq, 0.0), "model")
        sq = torch.where(mask, part, sq)
    return sq.sum().sqrt()


def all_reduce_grads(mesh, grads: Iterable[torch.Tensor], axis: str = "data") -> None:
    """Sum every gradient over ``axis`` in place, one all-reduce per dtype
    (the elementwise sums are those of one all-reduce per tensor)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in gs]), axis)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def batch_sharding(mesh) -> Spec:
    return ("data",)


def shard_batch(mesh, batch: Any) -> Any:
    """Every leaf's block of its leading dim over ``data`` (nested dicts of
    tensors or numpy arrays; the types are kept)."""
    n, i = mesh.shape["data"], mesh.rank("data")

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0:
            return block(x, n, i)
        return x

    return walk(batch)


def accum_sharding(mesh, accum: torch.Tensor) -> Spec:
    """A sparse-optimizer accumulator lives WITH its table's rows: [V]
    (rowwise) -> ("model",), [V, D] (exact) -> ("model", None), small
    tables replicated, by ``param_spec``'s row rule."""
    if mesh.shape["model"] > 1 and accum.shape[0] >= ROW_SHARD_MIN_VOCAB:
        return STACK if accum.ndim == 1 else ROWS
    return REPLICATED


def shard_accums(mesh, accums: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: _split(mesh, torch.as_tensor(a).to(mesh.device))
            if accum_sharding(mesh, a) else torch.as_tensor(a).to(mesh.device)
            for n, a in accums.items()}
