"""Pre-norm transformer block of the retrieval tower: the port of the JAX
package's ``ops/transformer.py``.

norm -> MHA -> dropout -> residual -> norm -> SwiGLU FFN -> dropout ->
residual, RMSNorm with float32 statistics, every dense layer in the input's
dtype. Dropout follows the ranking model's convention: a block given a seed
draws its masks from a generator of its own seeded with it, so a block that
``torch.utils.checkpoint`` recomputes draws the same masks again.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.models.ranking import _dropout
from recommend_tpu_torch.models.tokenizer import dense
from recommend_tpu_torch.ops.attention import MultiHeadAttention
from recommend_tpu_torch.ops.normalization import RMSNorm


class SwiGLUFFN(nn.Module):
    """(silu(x W_g) * x W_u) W_d."""

    def __init__(self, ffn_dim: int, embed_dim: int):
        super().__init__()
        self.gate = nn.Linear(embed_dim, ffn_dim)
        self.up = nn.Linear(embed_dim, ffn_dim)
        self.down = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        g = F.silu(dense(self.gate, x, dt))
        return dense(self.down, g * dense(self.up, x, dt), dt)


class TransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attn = MultiHeadAttention(num_heads, embed_dim)
        self.attn_norm = RMSNorm(embed_dim)
        self.ffn = SwiGLUFFN(ffn_dim, embed_dim)
        self.ffn_norm = RMSNorm(embed_dim)

    def forward(
        self,
        x: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """With ``deterministic=False`` and a dropout rate, ``dropout_seed``
        seeds the block's dropout masks."""
        rate = self.dropout_rate
        gen = None
        if not deterministic and rate > 0.0:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(dropout_seed)
        x = x + _dropout(self.attn(self.attn_norm(x), bias=bias), rate, gen)
        return x + _dropout(self.ffn(self.ffn_norm(x)), rate, gen)
