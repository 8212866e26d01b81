"""Brute-force top-k retrieval over the corpus matrix (the FAISS
replacement): the port of the JAX package's ``ops/topk.py``.

A candidate scores the max over a user's interests of its dot product with
them, in float32 from the operands' dtype (bf16 operands: exact products,
float32 sums, as ``preferred_element_type=f32``). Scores are not rounded to
bf16, which would tie and reorder the top k.

The scan never holds the [B, k, V] score tensor (10 GB of float32 at V = 10M,
B = 64, k = 4): it walks the corpus in row chunks, keeps a running top k per
query and merges each chunk's top k into it. The result is ``lax.top_k``'s:
the top k by score, ties broken by the lower id, at the k-th place too, in
that order. ``torch.topk`` promises no order among ties, so ``select_topk``
ranks on exact int64 keys (the score's bits, then the id), and a selection
that ``torch.topk`` cut at a tie sends the search through those keys. Equal
rows tie only where their products round alike: a BLAS may round a short
last chunk's columns an ulp apart from a full one's (seen on the CPU at
D = 4), where JAX's one product over the corpus keeps them equal.

``lax.approx_max_k`` has no PyTorch counterpart: ``recall_target`` runs the
exact top k, which meets any recall target.

``sharded_topk_retrieval`` scans a corpus row-sharded over a mesh axis: each
rank runs the chunked scan on its own rows, and only the k winners of each
rank cross the interconnect (an all-gather of [B, k]) before the merge.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

# the float32 scores of one scan chunk, at most
SCAN_CHUNK_BYTES = 1 << 30
# rows of the corpus quantized at once (bounds the float32 transient)
QUANTIZE_CHUNK_ROWS = 1 << 20


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with float32 products and sums. bf16
    operands on CUDA go through aten's ``out_dtype`` overload of mm/bmm where
    this torch has it; otherwise both are upcast first, which gives the same
    products (a bf16 x bf16 product is exact in float32)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        name = "mm" if a.dim() == 2 else "bmm"
        if "dtype" in getattr(torch.ops.aten, name).overloads():
            return getattr(torch, name)(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Copy tensors to host numpy with one wait on the device."""
    if tensors[0].device.type != "cuda":
        return tuple(t.numpy() for t in tensors)
    outs = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(o.numpy() for o in outs)


def _as_interests(interests: torch.Tensor) -> torch.Tensor:
    return interests[:, None, :] if interests.dim() == 2 else interests


def score_items(interests: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """interests [B, k, D] (or [B, D]) x items [V, D] -> [B, V] max-over-
    interest scores, in one shot (the plain scan: it holds [B·k, V])."""
    interests = _as_interests(interests)
    b, k, d = interests.shape
    s = matmul_f32(interests.reshape(b * k, d), items.T)
    return s.reshape(b, k, -1).amax(dim=1)


def select_topk(scores: torch.Tensor, rank: torch.Tensor, k: int) -> torch.Tensor:
    """Positions [B, k] of each row's top k of the float32 ``scores``,
    highest first, equal scores by ascending ``rank`` (broadcast to the
    scores; integers in [0, 2^32)): ``lax.top_k``'s order when ``rank`` is
    the position. Ranked on int64 keys, the score's bits mapped to a signed
    integer of the same order above the rank's complement, so no two keys
    tie."""
    bits = scores.float().contiguous().view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()
    return torch.topk(ordered * 2**32 + (2**32 - 1 - rank.long()), k, dim=1).indices


def _take(scores, ids, k):
    """The top k of (scores, ids) [B, n], ties by the lower id, in order."""
    j = select_topk(scores, ids, min(k, scores.shape[1]))
    return torch.gather(scores, 1, j), torch.gather(ids, 1, j)


def _select(scores, ids, k, exact):
    """Each row's top k of ``scores`` [B, n] with their ``ids`` -> (scores,
    ids, the rows where ``torch.topk`` cut a tie at the k-th score, or None).
    ``exact`` ranks on ``select_topk``'s keys instead, which cut no tie."""
    if scores.shape[1] <= k:
        return scores, ids, None
    if exact:
        return (*_take(scores, ids, k), None)
    # one more than k: a k-th score equal to the next is a tie that topk
    # cut, and which of the tied entries it kept is unspecified
    v, j = torch.topk(scores, k + 1, dim=1)
    return v[:, :k], torch.gather(ids, 1, j[:, :k]), v[:, k - 1] == v[:, k]


def _scan(n_rows, score_rows, k, chunk_rows, exact: bool):
    """One pass over the chunks, a running top k merged with each chunk's
    -> (scores, ids, the rows where a selection cut a tie, or None)."""
    best_s = best_i = cut = None
    for r0 in range(0, n_rows, chunk_rows):
        s = score_rows(r0, min(r0 + chunk_rows, n_rows))
        ids = torch.arange(r0, r0 + s.shape[1], device=s.device).expand(s.shape[0], -1)
        v, i, tie = _select(s, ids, k, exact)
        cut = _either(cut, tie)
        if best_s is not None:
            v, i, tie = _select(torch.cat([best_s, v], dim=1), torch.cat([best_i, i], dim=1),
                                k, exact)
            cut = _either(cut, tie)
        best_s, best_i = v, i
    return best_s, best_i, cut


def _either(a, b):
    """a | b of two optional boolean masks."""
    return b if a is None else a if b is None else a | b


def _scan_topk(
    n_rows: int,
    score_rows: Callable[[int, int], torch.Tensor],
    k: int,
    chunk_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k over the columns that ``score_rows(r0, r1)`` ([B, r1 - r0]
    scores of corpus rows r0..r1) gives, chunk by chunk, keeping a running
    top k, in ``lax.top_k``'s set and order. The chunks and the merges
    select with ``torch.topk``; where one cut a tie at its k-th score, the
    scan runs again on exact keys (one wait on the device per search, after
    the result is queued)."""
    s, i, cut = _scan(n_rows, score_rows, k, chunk_rows, exact=False)
    out = _take(s, i, k)
    if cut is not None and bool(cut.any()):
        out = _take(*_scan(n_rows, score_rows, k, chunk_rows, exact=True)[:2], k)
    return out


def _chunk_rows(query_rows: int, chunk_rows: Optional[int]) -> int:
    return chunk_rows or max(1024, SCAN_CHUNK_BYTES // (4 * query_rows))


def topk_retrieval(
    interests: torch.Tensor, items: torch.Tensor, k: int,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scan -> (scores [B, k] float32, ids [B, k] int64).
    ``chunk_rows``: corpus rows per chunk (default: as many as keep one
    chunk's [B·k, rows] float32 scores within ``SCAN_CHUNK_BYTES``)."""
    interests = _as_interests(interests)
    b, ki, d = interests.shape
    q = interests.reshape(b * ki, d)

    def score_rows(r0, r1):
        return matmul_f32(q, items[r0:r1].T).reshape(b, ki, -1).amax(dim=1)

    return _scan_topk(items.shape[0], score_rows, k, _chunk_rows(b * ki, chunk_rows))


def sharded_topk_retrieval(
    mesh, interests: torch.Tensor, items: torch.Tensor, k: int, axis: str = "data",
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded corpus: ``items`` is this rank's block of V/n rows
    (``parallel.shard_table(mesh, corpus, axis)``), ``interests`` the same
    on every rank -> (scores [B, k], global ids [B, k]), the same on every
    rank. Each rank's exact top k, ids offset by rank * V/n, are gathered in
    shard order and merged: ``lax.top_k``'s set and order over the whole
    corpus, ties at the k-th place to the lowest global id."""
    local_s, local_i = topk_retrieval(interests, items, k, chunk_rows)
    local_i = local_i + mesh.rank(axis) * items.shape[0]
    b, kk = local_s.shape
    with torch.no_grad():
        all_s = mesh.all_gather(local_s.contiguous(), axis)  # [n B, k], shard-major
        all_i = mesh.all_gather(local_i.contiguous(), axis)
    n = mesh.shape[axis]
    merged_s = all_s.reshape(n, b, kk).transpose(0, 1).reshape(b, n * kk)
    merged_i = all_i.reshape(n, b, kk).transpose(0, 1).reshape(b, n * kk)
    return _take(merged_s, merged_i, k)


def quantize_corpus(items: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of the [V, D] corpus ->
    (q_items int8 [V, D], scales float32 [V]); score(q, v) = (q · q_v) ·
    scale_v. Rows are quantized ``QUANTIZE_CHUNK_ROWS`` at a time, each on
    its own, so the result does not depend on the chunking."""
    v, d = items.shape
    q = torch.empty((v, d), dtype=torch.int8, device=items.device)
    scales = torch.empty((v,), dtype=torch.float32, device=items.device)
    for r0 in range(0, v, QUANTIZE_CHUNK_ROWS):
        x = items[r0:r0 + QUANTIZE_CHUNK_ROWS].float()
        s = x.abs().amax(dim=1) / 127.0
        q[r0:r0 + QUANTIZE_CHUNK_ROWS] = torch.round(x / s.clamp_min(1e-12)[:, None]).to(torch.int8)
        scales[r0:r0 + QUANTIZE_CHUNK_ROWS] = s
    return q, scales


def topk_retrieval_quantized(
    interests: torch.Tensor,  # [B, k, D] or [B, D] float
    q_items: torch.Tensor,  # [V, D] int8
    scales: torch.Tensor,  # [V] float32
    k: int,
    recall_target: Optional[float] = None,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-corpus scan: interests cast to bf16, int8 rows to bf16 (exact),
    float32 scores, max over interests, then the row's scale. Exact top k
    whatever ``recall_target`` says (no ``approx_max_k`` here)."""
    del recall_target  # the exact top k meets any recall target
    interests = _as_interests(interests)
    b, ki, d = interests.shape
    q = interests.reshape(b * ki, d).to(torch.bfloat16)

    def score_rows(r0, r1):
        s = matmul_f32(q, q_items[r0:r1].to(torch.bfloat16).T)
        return s.reshape(b, ki, -1).amax(dim=1) * scales[None, r0:r1]

    return _scan_topk(q_items.shape[0], score_rows, k, _chunk_rows(b * ki, chunk_rows))
