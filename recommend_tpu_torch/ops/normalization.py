"""RMSNorm with float32 statistics (oneTrans model.py:11-23)."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """y = x * rsqrt(mean(x^2) + eps) * scale.

    Statistics are computed in float32 whatever the input dtype, and the
    result is cast back to it.
    """

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)
