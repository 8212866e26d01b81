"""Ranking loss: ``multi_task_bce_loss``, the port's copy of the JAX
package's ``models/losses.py`` function of that name."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def multi_task_bce_loss(
    logits: Dict[str, torch.Tensor],  # per-task [B] pre-sigmoid logits
    labels: Dict[str, torch.Tensor],  # per-task [B] {0,1} labels
    task_weights: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of per-task sigmoid BCE, computed from logits in float32 as
    max(x, 0) - x y + log1p(exp(-|x|))."""
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    for task, lg in logits.items():
        y = labels[task].float()
        lg = lg.float()
        bce = torch.mean(lg.clamp_min(0.0) - lg * y + torch.log1p(torch.exp(-lg.abs())))
        w = 1.0 if task_weights is None else task_weights.get(task, 1.0)
        total = total + w * bce
        metrics[f"{task}_loss"] = bce
    metrics["loss"] = total
    return total, metrics
