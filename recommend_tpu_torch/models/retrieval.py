"""Multi-interest retrieval tower (KuaiFormer capability): the port of the
JAX package's ``models/retrieval.py``.

Feature-embed the history -> adaptive compression (256 -> 55 tokens) ->
append k learnable query tokens -> N pre-norm transformer blocks -> RMSNorm
-> the k query tokens' outputs are the user's interest vectors. A candidate
scores the max over interests of its dot product with them.

Modes, each one pass:
  - ``forward``: single prediction over ``[items(T); queries(k)]``,
    bidirectional, or causal among the items when ``use_causal_mask``;
  - ``all_position_interests``: the causal interests after every
    compressed-token prefix, over the interleaved sequence
    ``[items(T); query groups (T·k)]`` with a block mask (item t sees items
    <= t; query (t, j) sees items <= t and its own group);
  - ``interests_at_position``: the interests after one prefix per example;
  - ``masked_position_outputs``: BERT4Rec-style masked items;
  - ``item_embeddings``: the candidate side (the shared feature embedding).

Masks are additive float32 biases (-1e9 per masked term, so a key can take
two: -2e9, still finite in float32). Dropout and remat follow the ranking
model: with ``deterministic=False`` an explicit ``torch.Generator`` draws one
seed per block, and ``use_remat`` recomputes each block under
``torch.utils.checkpoint``. With the recorder on (``utils/profiling``) the
main stack of blocks is the span ``tower_blocks``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.ops.attention import NEG_INF
from recommend_tpu_torch.ops.compression import AdaptiveCompression
from recommend_tpu_torch.ops.embedding import FeatureEmbedding
from recommend_tpu_torch.ops.normalization import RMSNorm
from recommend_tpu_torch.ops.transformer import TransformerBlock
from recommend_tpu_torch.utils.profiling import span

Features = Dict[str, torch.Tensor]
Dummies = Optional[Dict[str, torch.Tensor]]


def _bias(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, NEG_INF).float()


def _single_prediction_bias(token_valid: torch.Tensor, num_query: int,
                            causal: bool) -> torch.Tensor:
    """Attention bias for the [items(T); queries(k)] sequence, [B, 1, L, L]."""
    b, t = token_valid.shape
    l = t + num_query
    dev = token_valid.device
    valid = torch.cat(
        [token_valid, torch.ones((b, num_query), dtype=torch.bool, device=dev)], dim=1)
    bias = _bias(valid[:, None, None, :]).expand(b, 1, l, l)
    if causal:
        # items causal among themselves; query tokens see all items + each other
        pos = torch.arange(l, device=dev)
        is_query = pos >= t
        allowed = (pos[None, :] <= pos[:, None]) | (is_query[None, :] & is_query[:, None])
        allowed = allowed | is_query[:, None]  # queries see every item
        bias = bias + _bias(allowed[None, None])
    return bias


def _interleaved_causal_bias(token_valid: torch.Tensor, num_query: int) -> torch.Tensor:
    """Bias for ``[items 0..T-1 ; q(0, 0..k-1) ; q(1, 0..k-1) ; ...]`` of
    length T·(1+k): item t sees items <= t; query (t, j) sees items <= t and
    the queries of its own group; padded items are masked as keys
    everywhere. Returns [B, 1, L, L]."""
    b, t = token_valid.shape
    k = num_query
    l = t + t * k
    dev = token_valid.device
    pos = torch.arange(l, device=dev)
    is_item = pos < t
    # the "time" of each slot: an item its own index, query group g its g
    q_time = torch.div(pos - t, max(k, 1), rounding_mode="floor")
    time = torch.where(is_item, pos, q_time)
    q_group = torch.where(is_item, -1 - pos, q_time)  # unique negatives for items
    causal_ok = is_item[None, :] & (time[None, :] <= time[:, None])
    group_ok = (~is_item[:, None]) & (q_group[None, :] == q_group[:, None])
    key_valid = torch.cat(
        [token_valid, torch.ones((b, t * k), dtype=torch.bool, device=dev)], dim=1)
    return _bias((causal_ok | group_ok)[None, None]) + _bias(key_valid[:, None, None, :])


def _position_bias(token_valid: torch.Tensor, num_query: int,
                   position: torch.Tensor) -> torch.Tensor:
    """Bias for ``[items(T); queries(k)]`` where the queries of example b
    see the items <= position[b] and each other; items are causal among
    themselves. Returns [B, 1, L, L]."""
    b, t = token_valid.shape
    l = t + num_query
    dev = token_valid.device
    pos = torch.arange(l, device=dev)
    is_query = pos >= t
    static_ok = (
        (pos[None, :] <= pos[:, None]) & ~is_query[None, :] & ~is_query[:, None]
    ) | (is_query[None, :] & is_query[:, None])
    q_to_item = (
        is_query[None, :, None]
        & (~is_query)[None, None, :]
        & (pos[None, None, :] <= position.long()[:, None, None])
    )  # [B, L, L]
    key_valid = torch.cat(
        [token_valid, torch.ones((b, num_query), dtype=torch.bool, device=dev)], dim=1)
    return _bias((static_ok[None] | q_to_item)[:, None]) + _bias(key_valid[:, None, None, :])


class RetrievalTower(nn.Module):
    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.config = cfg
        d = cfg.embed_dim
        pdt = getattr(torch, cfg.param_dtype)
        self.embed = FeatureEmbedding(cfg)
        self.compress = AdaptiveCompression(cfg)
        self.query_tokens = nn.Parameter(torch.empty(cfg.num_query_tokens, d, dtype=pdt))
        # learnable [MASK] item embedding of the masked-item mode
        self.mask_token = nn.Parameter(torch.empty(d, dtype=pdt))
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.ffn_dim, cfg.dropout_rate)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d)

    def _tokens(self, features: Features, valid: torch.Tensor,
                dummies: Dummies = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.compress(self.embed(features, dummies), valid)

    def _with_queries(self, tokens: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """[tokens ; query tokens repeated ``groups`` times]."""
        b, _, d = tokens.shape
        q = self.query_tokens.to(tokens.dtype).repeat(groups, 1)
        return torch.cat([tokens, q[None].expand(b, -1, d)], dim=1)

    def _blocks(self, x: torch.Tensor, bias: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        cfg = self.config
        seeds = [None] * cfg.num_layers
        if not deterministic and cfg.dropout_rate > 0.0:
            seeds = torch.randint(0, 2**62, (cfg.num_layers,), generator=generator).tolist()
        remat = cfg.use_remat and torch.is_grad_enabled()
        with span("tower_blocks"):
            for blk, seed in zip(self.blocks, seeds):
                if remat:
                    x = checkpoint(blk, x, bias, deterministic, seed, use_reentrant=False)
                else:
                    x = blk(x, bias, deterministic, seed)
        return x

    def forward(
        self,
        features: Features,
        valid: torch.Tensor,
        deterministic: bool = True,
        dummies: Dummies = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Single-prediction mode -> [B, k, D] interest vectors
        (causal among the items when ``cfg.use_causal_mask``). With
        ``deterministic=False`` the CPU ``generator`` (the default one when
        None) draws each block's dropout seed."""
        cfg = self.config
        tokens, token_valid = self._tokens(features, valid, dummies)
        t = tokens.shape[1]
        bias = _single_prediction_bias(token_valid, cfg.num_query_tokens, cfg.use_causal_mask)
        x = self._blocks(self._with_queries(tokens), bias, deterministic, generator)
        return self.final_norm(x[:, t:])

    def all_position_interests(
        self,
        features: Features,
        valid: torch.Tensor,
        deterministic: bool = True,
        dummies: Dummies = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Causal seq-to-seq mode -> [B, T, k, D]: the interests after every
        compressed-token prefix, in one pass."""
        cfg = self.config
        tokens, token_valid = self._tokens(features, valid, dummies)
        b, t, d = tokens.shape
        k = cfg.num_query_tokens
        bias = _interleaved_causal_bias(token_valid, k)
        x = self._blocks(self._with_queries(tokens, t), bias, deterministic, generator)
        return self.final_norm(x[:, t:]).reshape(b, t, k, d)

    def interests_at_position(
        self,
        features: Features,
        valid: torch.Tensor,
        position: torch.Tensor,  # [B] compressed-token index (0-based)
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Causal interests after one chosen prefix position -> [B, k, D]:
        one pass over ``[items(T); queries(k)]`` whose queries see the items
        <= ``position`` and each other, equal to row ``position`` of
        ``all_position_interests``."""
        cfg = self.config
        tokens, token_valid = self._tokens(features, valid)
        t = tokens.shape[1]
        bias = _position_bias(token_valid, cfg.num_query_tokens, position)
        x = self._blocks(self._with_queries(tokens), bias, deterministic, generator)
        return self.final_norm(x[:, t:])

    def masked_position_outputs(
        self,
        features: Features,
        valid: torch.Tensor,
        mask_positions: torch.Tensor,  # [B, M] raw indices into the tail segment
        deterministic: bool = True,
        dummies: Dummies = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """BERT4Rec-style masked-item mode: the item tokens at
        ``mask_positions`` (raw positions inside the uncompressed tail
        segment) become the learnable [MASK] embedding, the bidirectional
        stack runs, and the outputs at those token positions come back,
        [B, M, D]."""
        cfg = self.config
        x = self.embed(features, dummies)  # [B, L, D]
        b, l, d = x.shape
        onehot = nn.functional.one_hot(mask_positions.long(), l).to(x.dtype)  # [B, M, L]
        is_masked = onehot.sum(dim=1).clamp(0, 1)[..., None]  # [B, L, 1]
        x = x * (1 - is_masked) + self.mask_token.to(x.dtype)[None, None] * is_masked
        tokens, token_valid = self.compress(x, valid)
        t = tokens.shape[1]
        bias = _single_prediction_bias(token_valid, cfg.num_query_tokens, causal=False)
        h = self._blocks(self._with_queries(tokens), bias, deterministic, generator)
        h = self.final_norm(h[:, :t])
        # raw position p (within the tail segment) <-> token index t - (L - p)
        token_idx = t - (l - mask_positions.long())  # [B, M]
        return torch.gather(h, 1, token_idx[..., None].expand(-1, -1, d))

    def item_embeddings(self, features: Features, dummies: Dummies = None) -> torch.Tensor:
        """Candidate side: the same feature embedding as history items."""
        return self.embed(features, dummies)

    @staticmethod
    def compute_scores(interests: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
        """Max over interests of dot(candidate, interest), float32 products
        and sums. interests [B, k, D]; candidates [N, D] (shared) or
        [B, N, D]. Returns [B, N]."""
        eq = "bkd,nd->bkn" if candidates.dim() == 2 else "bkd,bnd->bkn"
        return torch.einsum(eq, interests.float(), candidates.float()).amax(dim=1)


def load_tower(cfg: RetrievalConfig, params, device: torch.device) -> RetrievalTower:
    """A frozen ``RetrievalTower(cfg)`` on ``device`` holding a copy of
    ``params`` (a state dict), whatever device the tensors are on: a tower
    never shares its weights with its caller or with another tower (the JAX
    package's holders each keep their own ``params``), so a trainer's
    in-place step never reaches a serving tower. At ``retrieval_flagship``
    the copy costs each holder the 10M x 128 float32 video table, 5.12 GB."""
    with torch.device("meta"):
        model = RetrievalTower(cfg)
    model.load_state_dict(
        {k: torch.as_tensor(v).to(device, copy=True) for k, v in params.items()}, assign=True)
    return model.eval().requires_grad_(False)
