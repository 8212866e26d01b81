"""Feature embedding of the retrieval tower: the port of the JAX package's
``ops/embedding.py``.

Five per-item features, ``video_id`` / ``category`` / ``tag`` (id lookups)
and ``duration`` / ``timestamp`` (bucketized), are embedded, concatenated and
fused by a two-layer MLP (tanh GELU) and an RMSNorm into one token per item.
Lookups are cast to the compute dtype, and the MLP runs in it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.models.tokenizer import dense
from recommend_tpu_torch.ops.normalization import RMSNorm
from recommend_tpu_torch.ops.sparse_embed import lookup_with_dummy


def bucketize_duration(duration_s: torch.Tensor, max_duration_s: float,
                       n_buckets: int) -> torch.Tensor:
    """value / max * n_buckets in float32, truncated, clipped."""
    b = (duration_s.float() / max_duration_s * n_buckets).to(torch.int64)
    return b.clamp(0, n_buckets - 1)


def bucketize_timestamp(ts: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """ts mod n_buckets (floor-mod, as JAX's)."""
    return ts.long() % n_buckets


# id-keyed tables eligible for sparse (touched-row) updates
SPARSE_TABLES = ("video_id", "category", "tag")


class FeatureEmbedding(nn.Module):
    """One token per item: 5 embeddings -> concat -> fusion MLP -> RMSNorm."""

    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.config = cfg
        d = cfg.embed_dim
        pdt = getattr(torch, cfg.param_dtype)
        vocab = {"video_id": cfg.video_vocab_size, "category": cfg.category_vocab_size,
                 "tag": cfg.tag_vocab_size, "duration": cfg.duration_buckets,
                 "timestamp": cfg.time_buckets}
        self.tables = nn.ModuleDict(
            {name: nn.Embedding(v, d, dtype=pdt) for name, v in vocab.items()})
        self.fuse_hidden = nn.Linear(5 * d, 2 * d)
        self.fuse_out = nn.Linear(2 * d, d)
        self.fuse_norm = RMSNorm(d)

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        dummies: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """features: ``video_id``, ``category``, ``tag`` (int ids),
        ``duration`` (float seconds), ``timestamp`` (int seconds), each
        [..., L]. Returns [..., L, D] tokens in the compute dtype.

        ``dummies`` (name -> zeros of ids.shape + [D] that require grad)
        route the id tables' gradients to per-lookup tensors for the sparse
        update; the bucket tables stay dense."""
        cfg = self.config
        cdt = getattr(torch, cfg.compute_dtype)
        dummies = dummies or {}

        def lookup(name, ids):
            return lookup_with_dummy(
                self.tables[name].weight, ids.long(), dummies.get(name)).to(cdt)

        x = torch.cat([
            lookup("video_id", features["video_id"]),
            lookup("category", features["category"]),
            lookup("tag", features["tag"]),
            lookup("duration", bucketize_duration(
                features["duration"], cfg.max_duration_s, cfg.duration_buckets)),
            lookup("timestamp", bucketize_timestamp(features["timestamp"], cfg.time_buckets)),
        ], dim=-1)
        x = F.gelu(dense(self.fuse_hidden, x, cdt), approximate="tanh")
        return self.fuse_norm(dense(self.fuse_out, x, cdt))
