"""Adaptive item compression of the retrieval tower: the port of the JAX
package's ``ops/compression.py``.

The L = 256 history splits into an early segment (128 items -> 2 groups of
64), a middle one (80 -> 5 groups of 16) and a late one (48 kept raw); each
group of the first two is encoded by a bidirectional transformer and
mean-pooled over its valid items into one token, 55 tokens in all. Every
segment's groups fold into the batch ([B, n·g, D] -> [B·n, g, D]), so one
encoder call per segment serves all its groups. A compressed token is valid
when its group holds any valid item. With the recorder on
(``utils/profiling``) a call is the span ``compression``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.ops.attention import FactoredBias, padding_mask_bias
from recommend_tpu_torch.ops.transformer import TransformerBlock
from recommend_tpu_torch.utils.profiling import span


class GroupEncoder(nn.Module):
    """Bidirectional encoder + masked mean-pool over a group."""

    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(cfg.embed_dim, cfg.num_heads, cfg.ffn_dim, 0.0)
            for _ in range(cfg.compression_layers))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x: [N, g, D], valid: [N, g] bool -> [N, D] pooled token; the
        pool's sums run in x's dtype. The mask is the padding bias alone, as
        the key part of a ``FactoredBias``."""
        bias = FactoredBias(None, padding_mask_bias(valid)[:, 0, 0])
        for layer in self.layers:
            x = layer(x, bias=bias)
        w = valid.to(x.dtype)[..., None]
        denom = w.sum(dim=1).clamp_min(1.0)
        return (x * w).sum(dim=1) / denom


class AdaptiveCompression(nn.Module):
    """256 -> 55 tokens with the default schedule. Segments kept raw
    (``group_size == 1``) have no encoder, so segment ``i``'s encoder is the
    submodule ``segment_{i}`` only where it compresses."""

    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.config = cfg
        for i, spec in enumerate(cfg.schedule_specs()):
            if spec.group_size > 1:
                self.add_module(f"segment_{i}", GroupEncoder(cfg))

    def forward(self, x: torch.Tensor,
                valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, L, D] item tokens; valid: [B, L] bool.
        Returns (tokens [B, T, D], token_valid [B, T])."""
        with span("compression"):
            cfg = self.config
            b, l, d = x.shape
            assert l == cfg.max_seq_len, (l, cfg.max_seq_len)
            out_tokens, out_valid = [], []
            offset = 0
            for i, spec in enumerate(cfg.schedule_specs()):
                seg = x[:, offset:offset + spec.length]
                seg_valid = valid[:, offset:offset + spec.length]
                offset += spec.length
                if spec.group_size == 1:
                    out_tokens.append(seg)
                    out_valid.append(seg_valid)
                    continue
                n, g = spec.num_tokens, spec.group_size
                gvalid = seg_valid.reshape(b * n, g)
                pooled = getattr(self, f"segment_{i}")(seg.reshape(b * n, g, d), gvalid)
                out_tokens.append(pooled.reshape(b, n, d))
                out_valid.append(gvalid.any(dim=-1).reshape(b, n))
            return torch.cat(out_tokens, dim=1), torch.cat(out_valid, dim=1)
