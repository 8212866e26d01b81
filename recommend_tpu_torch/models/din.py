"""DCNv2+DIN ranking baseline: the port of the JAX package's
``models/din.DINRankingModel``, the comparator OneTrans is measured against.

- Target attention per behavior sequence (DIN's local activation unit): an
  MLP over [key, query, key·query, key−query] scores each position, a
  softmax in float32 over the valid positions (−1e9 elsewhere) weighs them,
  and the weighted sum pools the sequence to one vector. A sequence with no
  valid position pools to exactly zero.
- The DCNv2 cross network, x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l with a
  full-rank W, beside a deep SiLU tower with dropout; their concat feeds
  per-task heads of ``RankingModel``'s shape (hidden GELU layer, one logit),
  in float32.
- The feature tables are those of ``UnifiedTokenizer`` (without its token
  stream), mounted under ``tokenizer.`` with ``RankingModel``'s names, so
  ``RankingTrainer(model=DINRankingModel(cfg))`` splits them out for the
  sparse update and feeds them its per-lookup dummies.

``forward`` has ``RankingModel``'s signature. The attention's keys are the
projected item vectors of ``UnifiedTokenizer.seq_item_embeds``; the
candidate query is sliced out of the dummy-added ``ns_concat`` (a second
lookup would read the tables outside autograd and lose the query's
gradient in the sparse update). Dropout bits come from the CPU
``generator`` as in ``RankingModel``: one seed per forward seeds a
generator on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.models.ranking import _dropout, gelu
from recommend_tpu_torch.models.tokenizer import UnifiedTokenizer, compute_dtype, dense

NEG_INF = -1e9


class DINRankingModel(nn.Module):
    def __init__(self, cfg: RankingConfig, num_cross_layers: int = 3,
                 deep_hidden: Sequence[int] = (512, 256), attn_hidden: int = 64):
        super().__init__()
        self.config = cfg
        d = cfg.embed_dim
        self.tokenizer = UnifiedTokenizer(cfg, token_stream=False)
        item_cols = sum(1 for f in cfg.non_seq_features if f in cfg.item_features)
        # candidate-item query: the item-group feature embeddings -> d
        self.query_proj = nn.Linear(item_cols * cfg.feature_embed_dim, d)
        # DIN's local activation unit, shared by the behavior sequences
        self.attn_hidden = nn.Linear(4 * d, attn_hidden)
        self.attn_out = nn.Linear(attn_hidden, 1)
        # NS concat + query + one pooled vector per behavior sequence (an
        # absent sequence pools to zeros, so the width is fixed)
        x0_dim = (len(cfg.non_seq_features) * cfg.feature_embed_dim
                  + sum(dim for _, dim in cfg.semantic_features)
                  + d * (1 + len(cfg.sequence_features)))
        self.cross = nn.ModuleList(nn.Linear(x0_dim, x0_dim)
                                   for _ in range(num_cross_layers))
        dims = (x0_dim, *deep_hidden)
        self.deep = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        z_dim = x0_dim + dims[-1]
        self.heads = nn.ModuleDict({
            t: nn.ModuleDict({
                "hidden": nn.Linear(z_dim, cfg.task_head_hidden),
                "out": nn.Linear(cfg.task_head_hidden, 1),
            })
            for t in cfg.tasks
        })

    def _target_attention(self, keys: torch.Tensor, valid: torch.Tensor,
                          query: torch.Tensor) -> torch.Tensor:
        """keys [B, L, d], validity [B, L], query [B, d] -> pooled [B, d]."""
        cdt = keys.dtype
        q = query[:, None, :].expand_as(keys)
        feats = torch.cat([keys, q, keys * q, keys - q], dim=-1)
        h = F.silu(dense(self.attn_hidden, feats, cdt))
        logits = dense(self.attn_out, h, cdt)[..., 0].float()
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        w = torch.softmax(logits, dim=-1)
        # a sequence with no valid position pools to exactly zero
        w = torch.where(valid.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
        return torch.einsum("bl,bld->bd", w.to(cdt), keys)

    def forward(
        self,
        non_seq: Dict[str, torch.Tensor],
        sequences: Dict[str, torch.Tensor],
        seq_valid: Dict[str, torch.Tensor],
        deterministic: bool = True,
        dummies: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-task logits [B]. ``dummies`` routes the embedding gradients to
        per-lookup tensors (sparse updates); with ``deterministic=False``
        the CPU ``generator`` seeds the deep tower's dropout."""
        cfg = self.config
        cdt = compute_dtype(cfg)
        ns = self.tokenizer.ns_concat(non_seq, dummies=dummies)  # [B, F·fe]
        fe = cfg.feature_embed_dim
        cols = [ns[:, i * fe:(i + 1) * fe] for i, f in enumerate(cfg.non_seq_features)
                if f in cfg.item_features and f in non_seq]
        query = dense(self.query_proj, torch.cat(cols, dim=-1), cdt)
        pooled = []
        for sf in cfg.sequence_features:
            if sf not in sequences:
                pooled.append(torch.zeros_like(query))
                continue
            keys = self.tokenizer.seq_item_embeds(sf, sequences[sf], dummies)
            pooled.append(self._target_attention(keys, seq_valid[sf], query))
        x0 = torch.cat([ns.to(cdt), query] + pooled, dim=-1)
        x = x0
        for w in self.cross:
            x = x0 * dense(w, x, cdt) + x
        gen = None
        if not deterministic and cfg.dropout_rate > 0.0:
            seed = torch.randint(0, 2**62, (1,), generator=generator).item()
            gen = torch.Generator(device=x0.device)
            gen.manual_seed(seed)
        deep = x0
        for layer in self.deep:
            deep = _dropout(F.silu(dense(layer, deep, cdt)), cfg.dropout_rate, gen)
        z = torch.cat([x, deep], dim=-1).float()
        return {t: head["out"](gelu(head["hidden"](z)))[..., 0]
                for t, head in self.heads.items()}
