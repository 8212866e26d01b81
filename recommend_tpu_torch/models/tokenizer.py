"""Unified tokenizer: one [S ; NS] token stream from sequence and
non-sequence features (oneTrans model.py:203-277; paper Eq. 7).

- NS path: embed every non-sequence feature, concatenate, and project with
  one dense layer to ``num_ns_tokens * d``, reshaped to [B, n_ns, d].
- S path: a shared item table and projection per behavior sequence, with a
  learnable [SEP] token *between* sequences (not after the last one).
- Layout [S ; NS]: under the causal band mask every S token is independent of
  the NS tokens, which is what makes the S-side K/V cacheable.

Training passes ``dummies`` (``ns_<feature>`` and ``seq_<sequence>`` zeros
that require grad, one row per lookup): each lookup then reads its table
outside autograd and adds its dummy, so the backward pass yields per-lookup
row gradients for the sparse update (``ops/sparse_embed.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.ops.sparse_embed import lookup_with_dummy

Dummies = Optional[Dict[str, torch.Tensor]]


def compute_dtype(cfg: RankingConfig) -> torch.dtype:
    return getattr(torch, cfg.active_compute_dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer computed in ``dtype``: input, weight and bias are cast
    to it first (flax ``Dense(dtype=...)`` with float32 parameters)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class UnifiedTokenizer(nn.Module):
    def __init__(self, cfg: RankingConfig, token_stream: bool = True):
        """``token_stream=False`` keeps the feature tables and the sequence
        projection alone (no ``ns_proj``, no [SEP]): the lookups that
        ``ns_concat`` and ``seq_item_embeds`` serve to a model that builds
        no token stream (DIN). The flax tokenizer of such a model has no
        ``ns_proj`` either: flax creates it only when it is called."""
        super().__init__()
        self.config = cfg
        tdt = getattr(torch, cfg.embedding_table_dtype)
        fe, d = cfg.feature_embed_dim, cfg.embed_dim
        self.embeds = nn.ModuleDict({
            f: nn.Embedding(cfg.vocab_size(f), fe, dtype=tdt)
            for f in cfg.non_seq_features
        })
        ns_in = fe * len(cfg.non_seq_features) + sum(
            dim for _, dim in cfg.semantic_features)
        if token_stream:
            self.ns_proj = nn.Linear(ns_in, cfg.num_ns_tokens * d)
        # NS-only configs (no behavior sequences) carry no item table
        if cfg.sequence_features:
            self.item_embed = nn.Embedding(
                cfg.vocab_size("item_id"), cfg.seq_item_feature_dim, dtype=tdt)
            self.seq_proj = nn.Linear(cfg.seq_item_feature_dim, d)
            if token_stream:
                self.sep_token = nn.Parameter(torch.empty(d))

    def _lookup(self, emb: nn.Embedding, ids: torch.Tensor,
                dummy: Optional[torch.Tensor] = None) -> torch.Tensor:
        return lookup_with_dummy(emb.weight, ids, dummy).to(compute_dtype(self.config))

    def ns_concat(
        self,
        non_seq: Dict[str, torch.Tensor],
        features: Optional[Tuple[str, ...]] = None,
        dummies: Dummies = None,
    ) -> torch.Tensor:
        """Concatenated per-feature embeddings [B, F·fe (+ semantic dims)];
        ``features`` restricts to a subset."""
        cfg = self.config
        feats = cfg.non_seq_features if features is None else features
        dummies = dummies or {}
        parts = [self._lookup(self.embeds[f], non_seq[f], dummies.get(f"ns_{f}"))
                 for f in feats]
        if features is None:
            for name, dim in cfg.semantic_features:
                feat = non_seq[name].to(parts[0].dtype)
                assert feat.shape[-1] == dim, (name, feat.shape, dim)
                parts.append(feat)
        return torch.cat(parts, dim=-1)

    def seq_item_embeds(self, sf: str, ids: torch.Tensor,
                        dummies: Dummies = None) -> torch.Tensor:
        """Projected item vectors [B, L, d] of one behavior sequence: the
        shared item table and projection, no [SEP] (the unit DIN's target
        attention pools)."""
        dummy = None if dummies is None else dummies.get(f"seq_{sf}")
        e = self._lookup(self.item_embed, ids, dummy)
        return dense(self.seq_proj, e, compute_dtype(self.config))

    def ns_tokens(self, non_seq: Dict[str, torch.Tensor],
                  dummies: Dummies = None) -> torch.Tensor:
        """[B] int features -> [B, n_ns, d] NS tokens."""
        cfg = self.config
        x = dense(self.ns_proj, self.ns_concat(non_seq, dummies=dummies),
                  compute_dtype(cfg))
        return x.reshape(x.shape[0], cfg.num_ns_tokens, cfg.embed_dim)

    def s_tokens(
        self,
        sequences: Dict[str, torch.Tensor],
        seq_valid: Dict[str, torch.Tensor],
        dummies: Dummies = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sequence item ids [B, L_i] -> ([B, Ls, d], [B, Ls] validity),
        sequences joined with [SEP] between them."""
        cfg = self.config
        toks, valids = [], []
        names = [f for f in cfg.sequence_features if f in sequences]
        for i, sf in enumerate(names):
            ids = sequences[sf]
            b = ids.shape[0]
            t = self.seq_item_embeds(sf, ids, dummies)
            toks.append(t)
            valids.append(seq_valid[sf])
            if i < len(names) - 1:
                toks.append(self.sep_token.to(t.dtype)[None, None].expand(b, 1, -1))
                valids.append(torch.ones((b, 1), dtype=torch.bool, device=ids.device))
        return torch.cat(toks, dim=1), torch.cat(valids, dim=1)

    def forward(
        self,
        non_seq: Dict[str, torch.Tensor],
        sequences: Dict[str, torch.Tensor],
        seq_valid: Dict[str, torch.Tensor],
        dummies: Dummies = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full token stream [S; NS] -> ([B, L, d], [B, L] validity)."""
        ns = self.ns_tokens(non_seq, dummies)
        b, dev = ns.shape[0], ns.device
        if not any(f in sequences for f in self.config.sequence_features):
            # NS-only stream: S length 0
            s = ns.new_zeros((b, 0, ns.shape[-1]))
            s_valid = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        else:
            s, s_valid = self.s_tokens(sequences, seq_valid, dummies)
        tokens = torch.cat([s, ns], dim=1)
        valid = torch.cat(
            [s_valid, torch.ones((b, ns.shape[1]), dtype=torch.bool, device=dev)],
            dim=1,
        )
        return tokens, valid
