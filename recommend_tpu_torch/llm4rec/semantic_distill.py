"""Semantic distillation two-tower student: the port of the JAX package's
``llm4rec/semantic_distill.py``.

An LLM labels user behavior offline; a light two-tower student distills its
embeddings so serving never calls the LLM:

- each tower maps a teacher embedding [B, Dt] through ``enc1`` -> GELU ->
  ``enc2`` -> GELU (tanh GELU, ``jax.nn.gelu``'s default), then through one
  stacked head parameter [num_heads, hidden, head_dim] applied as a single
  einsum, to heads [B, num_heads, head_dim] and their concatenation,
  L2-normalised (norm clamped at 1e-6), the [B, out_dim] vector;
- ``user_distill_proj`` / ``item_distill_proj`` map the vectors back to the
  teacher's width for the distillation terms;
- ``semantic_distill_loss``: in-batch softmax over cosine scores at
  temperature 0.05 (no label smoothing) plus the two teacher regressions.

``convert.init_semantic_distill_params`` draws a state dict as flax
initializes the JAX model, and ``convert.semantic_distill_params_from_flax``
converts a flax tree. The model computes in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.models.losses import in_batch_softmax_loss


@dataclass(frozen=True)
class SemanticDistillConfig:
    teacher_dim: int = 768  # LLM embedding width (teacher side)
    hidden_dim: int = 256
    num_heads: int = 4  # preference / attribute axes (category, topic, ...)
    head_dim: int = 32
    # loss weights: matching, user-side distill, item-side distill
    match_weight: float = 1.0
    user_distill_weight: float = 0.5
    item_distill_weight: float = 0.5

    @property
    def out_dim(self) -> int:
        return self.num_heads * self.head_dim  # 128 by default


class _Tower(nn.Module):
    def __init__(self, cfg: SemanticDistillConfig):
        super().__init__()
        self.cfg = cfg
        self.enc1 = nn.Linear(cfg.teacher_dim, cfg.hidden_dim)
        self.enc2 = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)
        self.head_stack = nn.Parameter(
            torch.empty(cfg.num_heads, cfg.hidden_dim, cfg.head_dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """teacher embedding [B, Dt] -> (vector [B, out_dim], heads [B, n, k])."""
        h = F.gelu(self.enc1(x), approximate="tanh")
        h = F.gelu(self.enc2(h), approximate="tanh")
        heads = torch.einsum("bd,ndk->bnk", h, self.head_stack)
        vec = heads.reshape(h.shape[0], self.cfg.out_dim)
        vec = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True).clamp_min(1e-6)
        return vec, heads


class SemanticDistillModel(nn.Module):
    """User tower + item tower sharing the config (separate parameters)."""

    def __init__(self, cfg: SemanticDistillConfig):
        super().__init__()
        self.cfg = cfg
        self.user_tower = _Tower(cfg)
        self.item_tower = _Tower(cfg)
        # the student's vector back in teacher space, for the distill terms
        self.user_distill_proj = nn.Linear(cfg.out_dim, cfg.teacher_dim)
        self.item_distill_proj = nn.Linear(cfg.out_dim, cfg.teacher_dim)

    def forward(self, user_teacher: torch.Tensor,
                item_teacher: torch.Tensor) -> Dict[str, torch.Tensor]:
        u_vec, u_heads = self.user_tower(user_teacher)
        i_vec, i_heads = self.item_tower(item_teacher)
        return {
            "user_vec": u_vec,
            "item_vec": i_vec,
            "user_heads": u_heads,
            "item_heads": i_heads,
            "user_recon": self.user_distill_proj(u_vec),
            "item_recon": self.item_distill_proj(i_vec),
        }

    def user_embedding(self, user_teacher: torch.Tensor) -> torch.Tensor:
        return self.user_tower(user_teacher)[0]

    def item_embedding(self, item_teacher: torch.Tensor) -> torch.Tensor:
        return self.item_tower(item_teacher)[0]


def semantic_distill_loss(
    cfg: SemanticDistillConfig,
    outputs: Dict[str, torch.Tensor],
    user_teacher: torch.Tensor,
    item_teacher: torch.Tensor,
    temperature: float = 0.05,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Matching (in-batch softmax over cosine scores) + the two distillation
    regressions -> (total, {"loss", "match_loss", "match_accuracy",
    "user_distill_loss", "item_distill_loss"})."""
    match, m = in_batch_softmax_loss(
        outputs["user_vec"][:, None, :] / temperature,
        outputs["item_vec"],
        label_smoothing=0.0,
    )
    ud = (outputs["user_recon"] - user_teacher).square().mean()
    idl = (outputs["item_recon"] - item_teacher).square().mean()
    total = (cfg.match_weight * match + cfg.user_distill_weight * ud
             + cfg.item_distill_weight * idl)
    return total, {
        "loss": total,
        "match_loss": match,
        "match_accuracy": m["in_batch_accuracy"],
        "user_distill_loss": ud,
        "item_distill_loss": idl,
    }
