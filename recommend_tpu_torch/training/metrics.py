"""Streaming ROC AUC: the port's copy of ``streaming_auc`` from the JAX
package's ``training/metrics.py``. A histogram accumulator over fixed
thresholds composes across batches without host round-trips."""

from __future__ import annotations

from typing import NamedTuple

import torch


class AUCState(NamedTuple):
    tp: torch.Tensor  # [T] true positives at each threshold
    fp: torch.Tensor
    num_pos: torch.Tensor  # scalar
    num_neg: torch.Tensor


def streaming_auc(num_thresholds: int = 512, device=None):
    """Returns (init, update, compute) for a batch-composable ROC AUC."""
    thresholds = torch.linspace(0.0, 1.0, num_thresholds, device=device)

    def init() -> AUCState:
        z = torch.zeros(num_thresholds, device=device)
        zero = torch.zeros((), device=device)
        return AUCState(z, z, zero, zero)

    def update(state: AUCState, probs: torch.Tensor, labels: torch.Tensor) -> AUCState:
        probs = probs.float().reshape(-1)
        labels = labels.float().reshape(-1)
        pred_pos = (probs[None, :] >= thresholds[:, None]).float()  # [T, B]
        tp = torch.sum(pred_pos * labels[None, :], dim=1)
        fp = torch.sum(pred_pos * (1.0 - labels[None, :]), dim=1)
        return AUCState(state.tp + tp, state.fp + fp,
                        state.num_pos + labels.sum(),
                        state.num_neg + (1.0 - labels).sum())

    def compute(state: AUCState) -> torch.Tensor:
        tpr = state.tp / state.num_pos.clamp_min(1.0)
        fpr = state.fp / state.num_neg.clamp_min(1.0)
        # thresholds ascending -> fpr/tpr descending; trapezoids
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)

    return init, update, compute
