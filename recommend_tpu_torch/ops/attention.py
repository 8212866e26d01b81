"""Plain attention: additive masks, the reference softmax attention and the
retrieval tower's multi-head attention layer.

Masks are additive and finite (-1e9), so a query whose keys are all masked
degrades to a uniform softmax rather than NaN. Logits and softmax run in
float32; the probabilities are cast to the value dtype before the PV product;
the output is in the query dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from recommend_tpu_torch.models.tokenizer import dense

NEG_INF = -1e9  # large-negative mask value, safe in bf16/f32


def causal_band_mask(
    q_len: int,
    kv_len: int,
    q_offset: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """[Lq, Lkv] additive causal mask for queries at the tail of the keys.

    Query i sits at absolute position ``q_offset + i`` (default
    ``kv_len - q_len``) and may attend to key positions <= its own.
    """
    if q_offset is None:
        q_offset = kv_len - q_len
    q_pos = torch.arange(q_len, device=device) + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    allowed = kv_pos[None, :] <= q_pos[:, None]
    return torch.where(allowed, 0.0, NEG_INF).float()


def padding_mask_bias(kv_valid: torch.Tensor) -> torch.Tensor:
    """[B, Lkv] boolean validity -> [B, 1, 1, Lkv] additive bias."""
    return torch.where(kv_valid[:, None, None, :], 0.0, NEG_INF).float()


def dot_product_attention(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lkv, H, Dh]
    v: torch.Tensor,  # [B, Lkv, H, Dh]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Lq, Lkv]
) -> torch.Tensor:
    """Reference attention. Softmax in float32; output in q.dtype.

    Products of bf16 values are exact in float32, so upcasting the operands
    and multiplying in float32 is the bf16 product with float32
    accumulation.
    """
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class MultiHeadAttention(nn.Module):
    """Shared-weight MHA with separate query/key-value inputs (the retrieval
    tower's and the compression encoder's). ``x_q`` and ``x_kv`` may differ
    in length. Flax's ``DenseGeneral((h, dh))`` kernels [D, H, Dh] and the
    output kernel [H, Dh, D] are stored flattened as ``nn.Linear`` weights;
    every projection runs in the input's dtype."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.o_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        x_q: torch.Tensor,  # [B, Lq, D]
        x_kv: Optional[torch.Tensor] = None,  # [B, Lkv, D]
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        dt = x_q.dtype

        def heads(layer, x):
            y = dense(layer, x, dt)
            return y.reshape(*y.shape[:-1], self.num_heads, -1)

        out = dot_product_attention(
            heads(self.q_proj, x_q), heads(self.k_proj, x_kv), heads(self.v_proj, x_kv),
            bias)
        return dense(self.o_proj, out.flatten(-2), dt)
