"""Inverted-file (IVF) index over the item-embedding corpus, the analog of
FAISS ``"IVF1024,Flat"``: the port of the JAX package's ``ops/ivf.py``.

- Build: Lloyd's k-means on the device. Assignment is the exact L2 rule
  (argmax x·c - |c|²/2) in corpus chunks, so the [V, C] score matrix never
  exists whole; the centroid update sums each cluster's rows in item order
  (a stable sort by cluster, then one segment sum per cluster), with no
  atomics, so two builds give the same index bit for bit. Empty clusters
  keep their centroid; centroids are cast back to the items' dtype at every
  iteration.
- Bucketing: items grouped into [C, capacity] id / embedding buckets, padded
  with id -1 (scored -inf); capacity defaults to the largest cluster (every
  item indexed once). With ``quantize="int8"`` the bucket embeddings are
  per-row-scaled int8, built a slab of clusters at a time to bound the
  float32 transient.
- Search: score centroids -> top-``nprobe`` buckets -> gather -> score the
  items -> top k. The gather is [N, nprobe, capacity, D], so ``query_chunk``
  queries go through it at a time. Both selections are ``lax.top_k``'s:
  ties go to the lower cluster, then to the earlier slot of the gathered
  [nprobe x capacity] list (not the lower item id), in that order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recommend_tpu_torch.ops.topk import matmul_f32, quantize_corpus, select_topk, to_host


class IVFIndex(NamedTuple):
    """Device-resident inverted-file index. With ``bucket_scales`` set,
    ``bucket_embs`` holds per-row-scaled int8 (score = (q · q_row) ·
    scale_row, as ``ops.topk.quantize_corpus``)."""

    centroids: torch.Tensor  # [n_clusters, D]
    bucket_ids: torch.Tensor  # [n_clusters, capacity] int64, -1 = padding
    bucket_embs: torch.Tensor  # [n_clusters, capacity, D] float -- or int8
    bucket_scales: Optional[torch.Tensor] = None  # [n_clusters, capacity] float32

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.bucket_ids.shape[1]


def _l2_assign_scores(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, D] x [C, D] -> [N, C] scores whose argmax is the L2-nearest
    centroid (argmin |x-c|² == argmax x·c - |c|²/2)."""
    half_sq = 0.5 * centroids.float().square().sum(dim=-1)
    return matmul_f32(x, centroids.T) - half_sq[None, :]


def _assign(items: torch.Tensor, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    out = torch.empty(items.shape[0], dtype=torch.int64, device=items.device)
    for r0 in range(0, items.shape[0], chunk):
        out[r0:r0 + chunk] = _l2_assign_scores(items[r0:r0 + chunk], centroids).argmax(dim=-1)
    return out


def _cluster_sums(items: torch.Tensor, assign: torch.Tensor,
                  n_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 row sums [C, D], counts [C]) per cluster, each cluster's
    rows summed in item order."""
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign, minlength=n_clusters)
    sums = torch.segment_reduce(items[order].float(), "sum", lengths=counts, axis=0,
                                unsafe=True)
    return sums, counts.float()


def kmeans_corpus(
    items: torch.Tensor,
    n_clusters: int,
    iters: int = 10,
    seed: int = 0,
    chunk: int = 65536,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Cluster a [V, D] matrix -> (centroids [C, D] on its device,
    assignments [V] int32 numpy): n_clusters clamped to V, the init drawn by
    ``np.random.default_rng(seed).choice(V, C, replace=False)`` as in the
    JAX package, then ``iters`` Lloyd steps."""
    items = torch.as_tensor(items)
    v = items.shape[0]
    n_clusters = min(n_clusters, v)
    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.choice(v, size=n_clusters, replace=False), device=items.device)
    centroids = items[init]
    for _ in range(iters):
        sums, counts = _cluster_sums(items, _assign(items, centroids, chunk), n_clusters)
        new = sums / counts.clamp_min(1.0)[:, None]
        # empty clusters keep their previous centroid
        centroids = torch.where((counts > 0)[:, None], new, centroids.float()).to(items.dtype)
    assign = _assign(items, centroids, chunk)
    return centroids, assign.cpu().numpy().astype(np.int32)


def _bucket_ids(assignments: np.ndarray, n_clusters: int, cap: int) -> np.ndarray:
    """[C, cap] ids: each cluster's items in ascending id order, padded with
    -1, those at or past ``cap`` in their cluster dropped."""
    order = np.argsort(assignments, kind="stable")
    cluster = assignments[order]
    first = np.searchsorted(cluster, np.arange(n_clusters))
    rank = np.arange(len(order)) - first[cluster]
    keep = rank < cap
    bucket_ids = np.full((n_clusters, cap), -1, dtype=np.int64)
    bucket_ids[cluster[keep], rank[keep]] = order[keep]
    return bucket_ids


def build_ivf(
    items: torch.Tensor,
    n_clusters: int = 1024,
    iters: int = 10,
    seed: int = 0,
    capacity: Optional[int] = None,
    chunk: int = 65536,
    quantize: Optional[str] = None,
) -> IVFIndex:
    """Cluster the [V, D] corpus and bucket it (row index == item id), on
    the corpus's device. ``capacity`` (rounded up to a multiple of 8, at
    least 8) defaults to the largest cluster."""
    assert quantize in (None, "int8"), quantize
    items = torch.as_tensor(items)
    v, d = items.shape
    n_clusters = min(n_clusters, v)
    centroids, assignments = kmeans_corpus(items, n_clusters, iters, seed, chunk)
    counts = np.bincount(assignments, minlength=n_clusters)
    cap = int(counts.max()) if capacity is None else int(capacity)
    cap = max(8, ((cap + 7) // 8) * 8)
    ids = torch.as_tensor(_bucket_ids(assignments, n_clusters, cap), device=items.device)
    if quantize != "int8":
        # padding slots read item 0; search masks them by id
        return IVFIndex(centroids, ids, items[ids.clamp_min(0)])
    embs = torch.empty((n_clusters, cap, d), dtype=torch.int8, device=items.device)
    scales = torch.empty((n_clusters, cap), dtype=torch.float32, device=items.device)
    slab = max(1, (1 << 28) // max(cap * d, 1))  # ~1 GB of float32 per slab
    for c0 in range(0, n_clusters, slab):
        q, s = quantize_corpus(items[ids[c0:c0 + slab].clamp_min(0)].reshape(-1, d))
        embs[c0:c0 + slab] = q.reshape(-1, cap, d)
        scales[c0:c0 + slab] = s.reshape(-1, cap)
    return IVFIndex(centroids, ids, embs, scales)


def ivf_search(
    index: IVFIndex, queries: torch.Tensor, k: int, nprobe: int = 32,
    query_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [N, D] -> (scores [N, k'], item ids [N, k']), k' = min(k,
    nprobe · capacity); ids -1 (score -inf) where fewer than k items were
    reachable. Inner-product scores, float32 (int8 buckets: bf16 queries
    against the int8 rows as bf16, times the row scale); probing uses the
    build's L2 rule. ``query_chunk`` queries at a time (all by default)."""
    n = queries.shape[0]
    nprobe = min(nprobe, index.n_clusters)
    chunk = query_chunk or n
    out_s, out_i = [], []
    for q0 in range(0, n, chunk):
        q = queries[q0:q0 + chunk]
        m = q.shape[0]
        cs = _l2_assign_scores(q, index.centroids)
        probe = select_topk(cs, torch.arange(cs.shape[1], device=q.device), nprobe)
        embs = index.bucket_embs[probe].reshape(m, -1, q.shape[1])  # [m, P·cap, D]
        ids = index.bucket_ids[probe].reshape(m, -1)
        if index.bucket_scales is not None:
            s = matmul_f32(embs.to(torch.bfloat16), q.to(torch.bfloat16)[:, :, None])[..., 0]
            s = s * index.bucket_scales[probe].reshape(m, -1)
        else:
            s = matmul_f32(embs, q[:, :, None])[..., 0]
        s = torch.where(ids >= 0, s, float("-inf"))
        pos = select_topk(s, torch.arange(s.shape[1], device=q.device), min(k, s.shape[1]))
        out_s.append(torch.gather(s, 1, pos))
        out_i.append(torch.gather(ids, 1, pos))
    return torch.cat(out_s), torch.cat(out_i)


def ivf_search_interests(
    index: IVFIndex,
    interests: torch.Tensor,
    k: int,
    nprobe: int = 32,
    query_chunk: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-interest search: each interest probes on its own, the results
    are merged by id keeping each id's best score, and the top k of the
    union comes back as host numpy (one device-to-host wait):
    interests [B, ki, D] -> (scores [B, k] float32, ids [B, k] int64), -inf
    and -1 past the ids found."""
    if interests.dim() == 2:
        interests = interests[:, None, :]
    b, ki, d = interests.shape
    s, i = ivf_search(index, interests.reshape(b * ki, d), k, nprobe, query_chunk)
    s, i = s.reshape(b, -1), i.reshape(b, -1)
    # each id's best score: sort by score, then stably by id, keep the first
    s, o = torch.sort(s, dim=1, descending=True, stable=True)
    i, o2 = torch.sort(torch.gather(i, 1, o), dim=1, stable=True)
    s = torch.gather(s, 1, o2)
    first = torch.ones_like(i, dtype=torch.bool)
    first[:, 1:] = i[:, 1:] != i[:, :-1]
    s = torch.where(first & (i >= 0), s, float("-inf"))
    kk = min(k, s.shape[1])
    # the top k of the union, ties by the lower id (padding ranks last)
    pos = select_topk(s, torch.where(i >= 0, i.long(), 2**32 - 1), kk)
    top_s = torch.gather(s, 1, pos)
    top_i = torch.where(torch.isinf(top_s), -1, torch.gather(i, 1, pos))
    out_s = torch.full((b, k), float("-inf"), device=s.device)
    out_i = torch.full((b, k), -1, dtype=torch.int64, device=s.device)
    out_s[:, :kk], out_i[:, :kk] = top_s, top_i
    return to_host(out_s, out_i)
