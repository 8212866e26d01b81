"""Sparse embedding updates: touched-row optimizer steps on the id tables.

The counterpart of the JAX package's ``ops/sparse_embed.py``. A dense
optimizer update on a [V, D] table costs O(V·D) memory traffic whatever the
batch touched; these cost O(N·D) for N lookups.

- ``lookup_with_dummy``: the table is read outside autograd and a
  ``requires_grad`` zeros "dummy" rides along, so the backward pass yields
  per-lookup row gradients [N, D] instead of a dense [V, D] table gradient.
- ``dedup_sum``: sort ids and segment-sum, so duplicate ids get exact adagrad
  semantics ((sum g)^2, not sum g^2). Static-shaped: [N] slots, those past
  the unique count carry id == vocab.
- ``sparse_adagrad_apply`` / ``sparse_update_table`` (exact mode) and
  ``sparse_rowwise_update_table`` (one accumulator scalar per row, the mode
  the benchmark config uses) update table and accumulator IN PLACE and
  return them.
- ``compact_valid_rows``: pack the valid (id, grad) rows into a fixed budget.

Duplicate ids are summed per segment of the sorted ids (``_group``,
``_segment_sum``: one thread sums a segment, in lookup order), and each
table row then takes one add, so a training run repeats bit for bit on CUDA
too, a resumed one included. CUDA's ``index_add_`` over duplicates adds
with atomics in whatever order the threads run: a resumed bf16 run and an
unbroken one drifted apart by 1.4e-4 in the loss within 4 steps on an H100.
``index_put_`` with ``accumulate`` is deterministic too but kept the host
waiting on every call.

Ids outside [0, vocab) -- the padding sentinel id == vocab above all -- are
dropped, as JAX's ``mode="drop"`` scatters drop them. PyTorch's index ops
fault on such an index (on CUDA as a device assert), so each one is sent to
row 0 with an exactly-zero contribution: x + 0 leaves the row as it was, and
nothing waits on the host to count the valid rows.

On a mesh a table may be held as a rank's row block: inside
``row_sharded({block: lookup})`` every ``lookup_with_dummy`` of that block
runs ``lookup`` (``parallel.sharded_lookup``) instead of a local gather.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from recommend_tpu_torch.utils.profiling import count, is_recording

# id(row block) -> its lookup, while a step on a mesh runs
_ROW_SHARDED: Dict[int, Callable] = {}


@contextmanager
def row_sharded(lookups: Mapping[torch.Tensor, Callable]):
    """Route the lookups of each given table block through its
    ``lookup(block, ids)`` for the duration of the block."""
    keys = [id(t) for t in lookups]
    _ROW_SHARDED.update(zip(keys, lookups.values()))
    try:
        yield
    finally:
        for k in keys:
            _ROW_SHARDED.pop(k, None)


def _embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def lookup_with_dummy(table: torch.Tensor, ids: torch.Tensor,
                      dummy: Optional[torch.Tensor]) -> torch.Tensor:
    """Embedding gather whose gradient flows into ``dummy`` (shape ids +
    [D]) instead of the table. With dummy=None this is a plain lookup."""
    gather = _ROW_SHARDED.get(id(table), _embedding)
    if dummy is None:
        return gather(table, ids)
    return gather(table.detach(), ids) + dummy


def make_dummy(ids_shape: Tuple[int, ...], dim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return torch.zeros(tuple(ids_shape) + (dim,), dtype=dtype, device=device,
                       requires_grad=True)


class _Groups(NamedTuple):
    order: torch.Tensor  # [N] stable sort of the ids
    lengths: torch.Tensor  # [N] lookups per segment, 0 past the unique count
    uids: torch.Tensor  # [N] each segment's id, vocab past the unique count


def _group(ids: torch.Tensor, vocab: int) -> _Groups:
    """The segments of equal ids in [0, vocab), in ascending id order, in
    static shapes. Each dropped lookup (an id outside [0, vocab): half of a
    padded batch's) is a segment of its own with id == vocab: one segment
    of them all would be summed by one thread, many times the atomic
    update's time on the H100."""
    n = ids.shape[0]
    live = (ids >= 0) & (ids < vocab)
    keys = torch.where(live, ids, vocab + torch.arange(n, dtype=ids.dtype, device=ids.device))
    sids, order = torch.sort(keys, stable=True)
    starts = torch.ones(n, dtype=torch.bool, device=ids.device)
    starts[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(starts.long(), 0) - 1  # segment index per sorted element
    # integer adds: the same in any order
    lengths = torch.zeros_like(seg).index_add_(0, seg, torch.ones_like(seg))
    uids = torch.full((n,), vocab, dtype=ids.dtype, device=ids.device)
    uids.scatter_(0, seg, sids.clamp_max(vocab))  # a segment's members write one id
    return _Groups(order, lengths, uids)


def _segment_sum(groups: _Groups, vals: torch.Tensor) -> torch.Tensor:
    """[N, ...] per-lookup values -> [N, ...] per-segment sums, each summed
    in lookup order (no atomics); segments past the unique count sum to 0."""
    return torch.segment_reduce(vals[groups.order], "sum", lengths=groups.lengths,
                                axis=0, unsafe=True)


def _dropped(ids: torch.Tensor, vocab: int):
    """(in-range mask, ids with out-of-range ones sent to row 0)."""
    keep = (ids >= 0) & (ids < vocab)
    return keep, torch.where(keep, ids, torch.zeros_like(ids))


def compact_valid_rows(
    ids: torch.Tensor,  # [N] int
    grads: torch.Tensor,  # [N, D]
    valid: torch.Tensor,  # [N] bool
    budget: int,
    vocab: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable-compact the valid (id, grad) rows into a [budget] buffer.
    Rows beyond ``budget`` are dropped and counted in ``n_dropped``; invalid
    and overflow slots come back with id == ``vocab`` and zero gradients."""
    n = ids.shape[0]
    dev = ids.device
    pos = torch.cumsum(valid.long(), 0) - 1
    dest = torch.where(valid, pos, torch.full_like(pos, budget)).clamp_max(budget)
    # slot ``budget`` collects the invalid and overflow rows and is cut off
    src = torch.full((budget + 1,), n, dtype=torch.long, device=dev)
    src.scatter_(0, dest, torch.arange(n, device=dev))
    src = src[:budget]
    ok = src < n
    safe = src.clamp_max(n - 1)
    ids_c = torch.where(ok, ids[safe], torch.full_like(ids[safe], vocab))
    g_c = grads[safe] * ok[:, None].to(grads.dtype)
    n_dropped = (valid.long().sum() - budget).clamp_min(0)
    return ids_c, g_c, n_dropped


def dedup_sum(ids: torch.Tensor, grads: torch.Tensor,
              vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (unique_ids [N], row_grads [N, D]): the sum of each id's gradients
    in ascending-id slots; slots past the unique count have id == vocab."""
    groups = _group(ids, vocab)
    return groups.uids, _segment_sum(groups, grads)


def sparse_adagrad_apply(
    table: torch.Tensor,  # [V, D]
    accum: torch.Tensor,  # [V, D]
    unique_ids: torch.Tensor,  # [N], unique except the id == vocab slots
    row_grads: torch.Tensor,  # [N, D]
    lr: float,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adagrad on the touched rows, in place (optax.scale_by_rss semantics:
    accum += g^2, update = g rsqrt(accum + eps) where accum > 0; pair with
    accumulators initialized to optax's 0.1)."""
    keep, safe = _dropped(unique_ids, table.shape[0])
    g = torch.where(keep[:, None], row_grads.float(), 0.0)
    g2 = g.square()
    acc_rows = accum[safe].float() + g2
    delta = lr * g * torch.where(acc_rows > 0, torch.rsqrt(acc_rows + eps), 0.0)
    # ids are unique (the dropped ones add exact zeros to row 0), so adding
    # g^2 sets accum[id] to acc_rows exactly, in any order
    accum.index_add_(0, safe, g2.to(accum.dtype))
    table.index_add_(0, safe, (-delta).to(table.dtype))
    return table, accum


def _count_rows(tag: Optional[str], groups: _Groups, vocab: int) -> None:
    """With the recorder on (``utils/profiling``), count table ``tag``'s
    lookups in [0, vocab) and the unique rows they touch (its in-range
    segments), as device tensors read at the recorder's export."""
    if tag is not None and is_recording():
        live = groups.uids < vocab  # each in-range segment holds one lookup or more
        count("sparse_lookups", torch.where(live, groups.lengths, 0).sum(), key=tag)
        count("sparse_unique_rows", live.sum(), key=tag)


def sparse_update_table(table, accum, ids, dummy_grads, lr: float,
                        eps: float = 1e-7, tag: Optional[str] = None):
    """Exact-mode update from raw lookups: dedup, then adagrad. ``tag``:
    the table's name, under which the recorder counts its rows."""
    d = table.shape[-1]
    groups = _group(ids.reshape(-1), table.shape[0])
    _count_rows(tag, groups, table.shape[0])
    row_grads = _segment_sum(groups, dummy_grads.reshape(-1, d))
    return sparse_adagrad_apply(table, accum, groups.uids, row_grads, lr, eps)


def sparse_rowwise_update_table(
    table: torch.Tensor,  # [V, D]
    row_accum: torch.Tensor,  # [V] float32, one accumulator scalar per row
    ids: torch.Tensor,  # any shape, flattened
    dummy_grads: torch.Tensor,  # ids.shape + [D]
    lr: float,
    eps: float = 1e-7,
    tag: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise adagrad, in place: every lookup adds its mean(g^2) to its
    row's accumulator, every lookup's delta uses the post-update accumulator
    of its row (duplicates share it), and each row takes the sum of its
    lookups' deltas. ``tag``: the table's name, under which the recorder
    counts its rows."""
    d = table.shape[-1]
    ids = ids.reshape(-1)
    keep, safe = _dropped(ids, table.shape[0])
    g = dummy_grads.reshape(-1, d).float()
    gsq = torch.where(keep, g.square().mean(-1), 0.0)
    groups = _group(ids, table.shape[0])
    _count_rows(tag, groups, table.shape[0])
    _, urows = _dropped(groups.uids, table.shape[0])
    row_accum.index_add_(0, urows, _segment_sum(groups, gsq).to(row_accum.dtype))
    acc_rows = row_accum[safe]
    scale = torch.where(keep & (acc_rows > 0), torch.rsqrt(acc_rows + eps), 0.0)
    delta = lr * g * scale[:, None]
    table.index_add_(0, urows, _segment_sum(groups, -delta).to(table.dtype))
    return table, row_accum
