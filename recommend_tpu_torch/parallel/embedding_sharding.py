"""Sharded embedding lookups on a mesh axis: the port of the JAX package's
``parallel/embedding_sharding.py``.

A table row-sharded over an axis of n ranks is held as contiguous blocks of
V/n rows, rank i holding rows [i V/n, (i + 1) V/n) (``shard_table``); a
column-sharded one as every row's i-th D/n slice (``shard_table_column``).

- ``sharded_lookup``: every rank gets the same ids, gathers the rows it
  owns (others -> zero rows), and one all-reduce over the axis assembles
  the embeddings, the same on every rank. Traffic O(B D).
- ``sharded_lookup_a2a``: each rank gets its own block of b ids, sorts and
  dedups them, buckets the unique ids by owner into an [n, capacity]
  request buffer, exchanges the requests (``all_to_all``), serves them from
  its rows and exchanges the rows back, then undoes the bucketing: the
  embedding-server wire protocol, O(unique D). Returns the rank's [b, D].
- ``sharded_lookup_column``: all-gather the ids, take the local column
  slice of every row, one ``all_to_all`` that splits the batch and joins
  the columns. Returns the rank's [b, D].

Negative ids and ids >= V resolve to zero rows; requests past ``capacity``
do too. Each lookup is differentiable: the masked local gather scatters its
gradient into the owner's rows only, the all-reduce's backward is the
identity (every rank consumes the same sum) and the all-to-all's the reverse
all-to-all (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recommend_tpu_torch.parallel.sharding import block


def shard_table(mesh, table: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's row block of a [V, D] table (V must divide evenly)."""
    n = mesh.shape[axis]
    assert table.shape[0] % n == 0, (tuple(table.shape), n)
    return block(table, n, mesh.rank(axis)).to(mesh.device).clone()


def _local_rows(table: torch.Tensor, ids: torch.Tensor, offset: int) -> torch.Tensor:
    """Rows of the global ``ids`` that this block (rows offset..offset + v)
    owns, zero rows elsewhere."""
    v = table.shape[0]
    local = ids - offset
    owned = (local >= 0) & (local < v)
    rows = F.embedding(local.clamp(0, v - 1), table)
    return torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def sharded_lookup(mesh, table: torch.Tensor, ids: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
    """``table``: this rank's row block; ``ids``: any int shape, the same on
    every rank -> embeddings of shape ids.shape + [D], the same on every
    rank."""
    v = table.shape[0]
    flat = ids.reshape(-1).long()
    rows = _local_rows(table, flat, mesh.rank(axis) * v)
    return mesh.psum(rows, axis).reshape(tuple(ids.shape) + (table.shape[1],))


def sharded_lookup_a2a(mesh, table: torch.Tensor, ids: torch.Tensor,
                       axis: str = "model", capacity: int = 0) -> torch.Tensor:
    """Dedup + all-to-all lookup. ``table``: this rank's row block; ``ids``:
    this rank's [b] block of the batch -> its [b, D] rows.

    ``capacity`` is the per-owner request budget; 0 means b (exact for any
    id distribution: a rank never asks one owner for more than its b unique
    ids). Requests past it are dropped and resolve to zero rows, as do
    negative ids and ids >= V (V = n * this block's rows)."""
    n, shard = mesh.shape[axis], mesh.rank(axis)
    local_v, d = table.shape
    v = local_v * n
    b = ids.shape[0]
    cap = capacity if capacity > 0 else b
    dev = ids.device
    ids = ids.long()
    # negative ids are invalid like ids >= v: fold them into the v sentinel
    # so they sort to the tail with the other invalids
    ids = torch.where(ids < 0, v, ids)
    # 1. sort + dedup
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    first = torch.ones(b, dtype=torch.bool, device=dev)
    first[1:] = sids[1:] != sids[:-1]
    uslot = torch.cumsum(first.long(), 0) - 1  # sorted position -> unique slot
    uids = torch.full((b,), v, dtype=torch.long, device=dev).scatter_(0, uslot, sids)
    pos2slot = torch.empty_like(uslot).scatter_(0, order, uslot)
    # 2. bucket the unique ids by owner (ascending ids: owners grouped)
    owner = torch.where(uids >= v, n, uids // local_v)
    start = torch.searchsorted(owner, torch.arange(n, device=dev))
    within = torch.arange(b, device=dev) - start[owner.clamp(0, n - 1)]
    ok = (owner < n) & (within < cap)  # overflow / invalid -> zero row
    slot = torch.where(ok, owner * cap + within, n * cap)  # n * cap: dropped
    req = torch.full((n * cap + 1,), v, dtype=torch.long, device=dev)
    req = req.scatter_(0, slot, uids)[: n * cap]
    # 3. exchange requests; serve them from the local block
    peer_req = mesh.all_to_all(req, axis)  # chunk j: the ids rank j asked me for
    rows = _local_rows(table, peer_req, shard * local_v)
    # 4. rows back to the requesters; undo the bucketing and the dedup
    got = mesh.all_to_all(rows, axis)  # chunk j answers my requests to rank j
    urows = got[torch.where(ok, slot, 0)]
    urows = torch.where(ok[:, None], urows, torch.zeros((), dtype=urows.dtype, device=dev))
    return urows[pos2slot]


def shard_table_column(mesh, table: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's column block [V, D/n] of a [V, D] table."""
    n = mesh.shape[axis]
    assert table.shape[1] % n == 0, (tuple(table.shape), n)
    return block(table.T, n, mesh.rank(axis)).T.to(mesh.device).contiguous()


def sharded_lookup_column(mesh, table: torch.Tensor, ids: torch.Tensor,
                          axis: str = "model") -> torch.Tensor:
    """Column-sharded lookup. ``table``: this rank's [V, D/n] columns;
    ``ids``: this rank's [b] block -> its [b, D] rows (ids outside [0, V)
    -> zero rows)."""
    n = mesh.shape[axis]
    v, dn = table.shape
    b = ids.shape[0]
    with torch.no_grad():
        all_ids = mesh.all_gather(ids.long(), axis)  # [B]
    cols = _local_rows(table, all_ids, 0)  # [B, D/n]
    got = mesh.all_to_all(cols, axis)  # chunk i: my rows, rank i's columns
    return got.reshape(n, b, dn).permute(1, 0, 2).reshape(b, n * dn)
