"""Losses: the port's copy of the JAX package's ``models/losses.py``.

- ``in_batch_softmax_loss``: the retrieval tower's sampled softmax over the
  in-batch [B, B] score matrix, with LogQ popularity correction and label
  smoothing;
- ``seq2seq_in_batch_loss``: that loss at every supervised position,
  weighted by each position's count of valid rows;
- ``multi_task_bce_loss``: the ranking model's per-task binary cross-entropy
  summed over tasks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _in_batch(
    interests: torch.Tensor,  # [R, B, k, D]
    items: torch.Tensor,  # [R, B, D]
    popularity: Optional[torch.Tensor],  # [R, B]
    label_smoothing: float,
    valid: Optional[torch.Tensor],  # [R, B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position (loss [R], in-batch accuracy [R]) of R independent
    in-batch softmaxes, in one batched product."""
    b = interests.shape[1]
    # [R, B, B]: row = user, column = item, the max over the k interests
    logits = torch.einsum("rbkd,rnd->rbkn", interests.float(), items.float()).amax(dim=2)
    if popularity is not None:
        logits = logits - torch.log(popularity.float() + 1e-8)[:, None, :]
    a = label_smoothing
    eye = torch.eye(b, dtype=torch.bool, device=logits.device)
    targets = torch.where(eye, 1.0 - a, a / max(b - 1, 1))
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    per_row = -(targets * (logits - logz)).sum(dim=-1)  # [R, B]
    # torch.argmax, like jnp.argmax, returns the first maximal index
    correct = logits.argmax(dim=-1) == torch.arange(b, device=logits.device)
    if valid is None:
        return per_row.mean(dim=-1), correct.float().mean(dim=-1)
    w = valid.float()
    denom = w.sum(dim=-1).clamp_min(1.0)
    return (per_row * w).sum(dim=-1) / denom, (correct & valid).float().sum(dim=-1) / denom


def in_batch_softmax_loss(
    interests: torch.Tensor,  # [B, k, D]
    item_embeddings: torch.Tensor,  # [B, D]: each row's positive item
    item_popularity: Optional[torch.Tensor] = None,  # [B] sampling probability
    label_smoothing: float = 0.1,
    valid: Optional[torch.Tensor] = None,  # [B] rows to include
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled softmax: row i's positive is item i, the other B - 1
    items its negatives. The [B, B] logits are the float32 max over the
    interests; LogQ subtracts log(popularity + 1e-8) from every column;
    label smoothing puts 1 - α on the diagonal and α / max(B - 1, 1) off
    it. With ``valid``, the loss and the accuracy are means over the valid
    rows (a denominator of at least 1). Returns (loss, {"loss",
    "in_batch_accuracy"})."""
    loss, acc = _in_batch(
        interests[None], item_embeddings[None],
        None if item_popularity is None else item_popularity[None], label_smoothing,
        None if valid is None else valid[None])
    return loss[0], {"loss": loss[0], "in_batch_accuracy": acc[0]}


def seq2seq_in_batch_loss(
    interests: torch.Tensor,  # [B, R, k, D] interests at each position
    item_embeddings: torch.Tensor,  # [B, R, D] next item at each position
    item_popularity: Optional[torch.Tensor],  # [B, R]
    valid: torch.Tensor,  # [B, R] positions with a valid (current, next) pair
    label_smoothing: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``in_batch_softmax_loss`` at each of the R positions, against the
    items of the same position across the batch, with ``valid``; the
    positions are weighted by their count of valid rows."""
    losses, accs = _in_batch(
        interests.transpose(0, 1), item_embeddings.transpose(0, 1),
        None if item_popularity is None else item_popularity.transpose(0, 1),
        label_smoothing, valid.transpose(0, 1))
    w = valid.float().sum(dim=0)  # [R]
    wsum = w.sum().clamp_min(1.0)
    loss = (losses * w).sum() / wsum
    return loss, {"loss": loss, "in_batch_accuracy": (accs * w).sum() / wsum}


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
