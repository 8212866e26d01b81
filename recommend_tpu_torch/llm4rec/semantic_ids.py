"""Semantic-ID pipeline: the port of the JAX package's
``llm4rec/semantic_ids.py``.

Embed every item with an LLM, cluster the embeddings, replace item-id
behavior sequences with cluster-id ("semantic id") sequences, and train
next-cluster-id prediction:

- clustering is the IVF index's k-means (``ops/ivf.kmeans_corpus``: Lloyd's
  on the embeddings' device, each cluster summed in item order, so two
  builds are bit-equal and the assignments equal JAX's);
- next-cluster-id prediction is the retrieval tower over the semantic
  vocabulary: ``remap_retrieval_data`` turns a dataset's item ids into
  cluster ids, and ``RetrievalTrainer`` trains on it unchanged (vocabulary
  ``n_clusters + 1``, the last id the padding one);
- items unseen at build time take their nearest centroid
  (``SemanticIdMap.assign``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List

import numpy as np
import torch

from recommend_tpu_torch.ops.ivf import _l2_assign_scores, kmeans_corpus


@dataclass(frozen=True)
class SemanticIdMap:
    """item id -> semantic (cluster) id, plus the centroids for cold items."""

    centroids: torch.Tensor  # [K, D] on the build's device
    item_to_sid: np.ndarray  # [V] int32

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    def map_ids(self, ids: np.ndarray) -> np.ndarray:
        """Item-id array (any shape) -> semantic-id array. Ids >= V (the
        padding sentinel V, or out of the vocabulary) map to n_clusters, the
        semantic padding id."""
        v = self.item_to_sid.shape[0]
        ids = np.asarray(ids)
        safe = np.minimum(ids, v - 1)
        sids = self.item_to_sid[safe]
        return np.where(ids < v, sids, self.n_clusters).astype(np.int32)

    def assign(self, embeddings) -> torch.Tensor:
        """Nearest-centroid semantic ids [N] int32, on the centroids'
        device, for new item embeddings [N, D] (taken in the centroids'
        dtype): the cold-start path."""
        x = torch.as_tensor(embeddings).to(self.centroids.device, self.centroids.dtype)
        return _l2_assign_scores(x, self.centroids).argmax(dim=-1).to(torch.int32)


def build_semantic_ids(
    item_embeddings,  # [V, D] LLM embeddings, row == id: a tensor or numpy
    n_clusters: int = 1024,
    iters: int = 10,
    seed: int = 0,
    chunk: int = 65536,
) -> SemanticIdMap:
    """Cluster the item-embedding matrix into semantic ids, on its device
    (a float64 numpy matrix is taken as float32, JAX's default float)."""
    if isinstance(item_embeddings, np.ndarray) and item_embeddings.dtype == np.float64:
        item_embeddings = item_embeddings.astype(np.float32)
    centroids, assignments = kmeans_corpus(item_embeddings, n_clusters, iters, seed, chunk)
    return SemanticIdMap(centroids=centroids, item_to_sid=assignments)


def remap_retrieval_data(data, sid_map: SemanticIdMap):
    """``SyntheticRetrievalData`` (or compatible) -> the same dataset over
    the semantic-id vocabulary: video_id sequences become cluster-id
    sequences, popularity aggregates per cluster, per-cluster features take
    the most popular member's value. Feed the result to the retrieval
    pipeline and trainer for next-semantic-id training."""
    k = sid_map.n_clusters
    sid_of = sid_map.item_to_sid
    pop = np.zeros(k, dtype=data.popularity.dtype)
    np.add.at(pop, sid_of, data.popularity)
    # modal (most popular member's) features per cluster
    feats: Dict[str, np.ndarray] = {}
    best = np.full(k, -1, dtype=np.int64)
    order = np.argsort(data.popularity, kind="stable")  # ascending
    best[sid_of[order]] = order  # last write = most popular member
    safe_best = np.maximum(best, 0)
    for name, col in data.video_features.items():
        feats[name] = np.where(best >= 0, col[safe_best], 0).astype(col.dtype)
    seqs: List[Dict[str, np.ndarray]] = []
    for user in data.user_sequences:
        u = dict(user)
        vid = u["video_id"]
        sids = sid_map.map_ids(vid)
        u["video_id"] = sids
        # map_ids sends padding/OOV ids to n_clusters, which is past the end
        # of the [k]-length per-cluster feature columns: gather clipped and
        # zero those positions (they are padding downstream anyway)
        safe_sids = np.minimum(sids, k - 1)
        for name in feats:
            if name in u:
                u[name] = np.where(
                    sids < k, feats[name][safe_sids], 0
                ).astype(feats[name].dtype)
        seqs.append(u)
    return replace(data, video_features=feats, popularity=pop, user_sequences=seqs)
