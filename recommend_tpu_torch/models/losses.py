"""Losses: the port's copy of the JAX package's ``models/losses.py``.

- ``in_batch_softmax_loss``: the retrieval tower's sampled softmax over the
  in-batch [B, B] score matrix, with LogQ popularity correction and label
  smoothing;
- ``seq2seq_in_batch_loss``: that loss at every supervised position,
  weighted by each position's count of valid rows;
- ``multi_task_bce_loss``: the ranking model's per-task binary cross-entropy
  summed over tasks.

With a ``mesh`` the two in-batch losses keep the global batch's semantics
on a batch split over its ``data`` axis: the items (and popularities) of
every rank are gathered to be each rank's columns, through an all-gather
whose backward is a reduce-scatter, so each rank scores its rows against
all B candidates; the counts of valid rows are global. Each rank returns
its share of the global loss and metrics: the sum over ranks is what one
device computes on the whole batch. With the recorder on
(``utils/profiling``) each in-batch loss is the span ``in_batch_loss``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from recommend_tpu_torch.utils.profiling import span


def _in_batch(
    interests: torch.Tensor,  # [R, b, k, D]: this rank's rows
    items: torch.Tensor,  # [R, B, D]: every rank's columns
    popularity: Optional[torch.Tensor],  # [R, B]
    label_smoothing: float,
    valid: Optional[torch.Tensor],  # [R, b]
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position (loss [R], in-batch accuracy [R]) of R independent
    in-batch softmaxes, in one batched product; on a mesh this rank's share
    of them (its rows start at column rank * b)."""
    b, n = interests.shape[1], items.shape[1]
    offset = 0 if mesh is None else mesh.rank("data") * b
    # [R, b, B]: row = user, column = item, the max over the k interests
    logits = torch.einsum("rbkd,rnd->rbkn", interests.float(), items.float()).amax(dim=2)
    if popularity is not None:
        logits = logits - torch.log(popularity.float() + 1e-8)[:, None, :]
    a = label_smoothing
    rows = torch.arange(offset, offset + b, device=logits.device)
    eye = rows[:, None] == torch.arange(n, device=logits.device)[None, :]
    targets = torch.where(eye, 1.0 - a, a / max(n - 1, 1))
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    per_row = -(targets * (logits - logz)).sum(dim=-1)  # [R, b]
    # torch.argmax, like jnp.argmax, returns the first maximal index
    correct = logits.argmax(dim=-1) == rows
    if valid is None:
        share = b / n  # this rank's rows of the mean (1 on one device)
        return per_row.mean(dim=-1) * share, correct.float().mean(dim=-1) * share
    w = valid.float()
    denom = _global_sum(w.sum(dim=-1), mesh).clamp_min(1.0)
    return (per_row * w).sum(dim=-1) / denom, (correct & valid).float().sum(dim=-1) / denom


def _global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's data axis (outside autograd)."""
    if mesh is None:
        return x
    return mesh.all_reduce_(x.detach().clone(), "data")


def _columns(x: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    """[b, ...] -> every rank's [B, ...] (dim 0), differentiable."""
    if x is None or mesh is None:
        return x
    return mesh.all_gather(x, "data")


def in_batch_softmax_loss(
    interests: torch.Tensor,  # [B, k, D]
    item_embeddings: torch.Tensor,  # [B, D]: each row's positive item
    item_popularity: Optional[torch.Tensor] = None,  # [B] sampling probability
    label_smoothing: float = 0.1,
    valid: Optional[torch.Tensor] = None,  # [B] rows to include
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled softmax: row i's positive is item i, the other B - 1
    items its negatives. The [B, B] logits are the float32 max over the
    interests; LogQ subtracts log(popularity + 1e-8) from every column;
    label smoothing puts 1 - α on the diagonal and α / max(B - 1, 1) off
    it. With ``valid``, the loss and the accuracy are means over the valid
    rows (a denominator of at least 1). Returns (loss, {"loss",
    "in_batch_accuracy"}); on a ``mesh``, this rank's share of them."""
    with span("in_batch_loss"):
        loss, acc = _in_batch(
            interests[None], _columns(item_embeddings, mesh)[None],
            None if item_popularity is None else _columns(item_popularity, mesh)[None],
            label_smoothing, None if valid is None else valid[None], mesh)
    return loss[0], {"loss": loss[0], "in_batch_accuracy": acc[0]}


def seq2seq_in_batch_loss(
    interests: torch.Tensor,  # [B, R, k, D] interests at each position
    item_embeddings: torch.Tensor,  # [B, R, D] next item at each position
    item_popularity: Optional[torch.Tensor],  # [B, R]
    valid: torch.Tensor,  # [B, R] positions with a valid (current, next) pair
    label_smoothing: float = 0.1,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``in_batch_softmax_loss`` at each of the R positions, against the
    items of the same position across the batch, with ``valid``; the
    positions are weighted by their count of valid rows. On a ``mesh``,
    this rank's share."""
    with span("in_batch_loss"):
        losses, accs = _in_batch(
            interests.transpose(0, 1), _columns(item_embeddings, mesh).transpose(0, 1),
            None if item_popularity is None else _columns(item_popularity, mesh).transpose(0, 1),
            label_smoothing, valid.transpose(0, 1), mesh)
        w = _global_sum(valid.float().sum(dim=0), mesh)  # [R]
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
