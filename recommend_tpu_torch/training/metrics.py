"""Metrics: the port of the JAX package's ``training/metrics.py``.

- Retrieval ranking metrics over scores [B, N] (higher is better) and the
  true item's column [B]: HR@K (= Recall@K with one positive), NDCG@K, MRR
  and their suite. The true item's rank counts the scores above it (ties
  broken pessimistically).
- ``streaming_auc``: a histogram accumulator over fixed thresholds that
  composes across batches without host round-trips.
- ``exact_auc`` (tie-corrected Mann-Whitney) and ``grouped_auc`` (UAUC):
  numpy on the host, copied from the JAX package line for line.
- ``binary_classification_suite``: accuracy, precision, recall, F1 and
  logloss of one batch, in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


def _rank_of_true(scores: torch.Tensor, true_idx: torch.Tensor) -> torch.Tensor:
    true_score = torch.gather(scores, 1, true_idx[:, None].long())
    return (scores > true_score).sum(dim=1)


def hit_rate_at_k(scores: torch.Tensor, true_idx: torch.Tensor, k: int) -> torch.Tensor:
    """HR@K, which is Recall@K for single-positive evaluation."""
    return (_rank_of_true(scores, true_idx) < k).float().mean()


def ndcg_at_k(scores: torch.Tensor, true_idx: torch.Tensor, k: int) -> torch.Tensor:
    rank = _rank_of_true(scores, true_idx)
    gain = 1.0 / torch.log2(rank.float() + 2.0)
    return torch.where(rank < k, gain, torch.zeros_like(gain)).mean()


def mrr(scores: torch.Tensor, true_idx: torch.Tensor) -> torch.Tensor:
    return (1.0 / (_rank_of_true(scores, true_idx).float() + 1.0)).mean()


def retrieval_metric_suite(
    scores: torch.Tensor,
    true_idx: torch.Tensor,
    ks: Tuple[int, ...] = (1, 5, 10, 50, 100),
) -> Dict[str, torch.Tensor]:
    out = {}
    for k in ks:
        if k <= scores.shape[1]:
            out[f"recall@{k}"] = hit_rate_at_k(scores, true_idx, k)
            out[f"ndcg@{k}"] = ndcg_at_k(scores, true_idx, k)
    out["mrr"] = mrr(scores, true_idx)
    return out


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
        # in float64, then back: a float32 sum of the 511 trapezoids reads
        # 1 + 2^-23 at perfect separation
        tpr = state.tp.double() / state.num_pos.double().clamp_min(1.0)
        fpr = state.fp.double() / state.num_neg.double().clamp_min(1.0)
        # thresholds ascending -> fpr/tpr descending; trapezoids
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).float()

    return init, update, compute


def exact_auc(probs, labels) -> float:
    """Exact tie-corrected ROC AUC (Mann-Whitney U with midranks), NaN when
    a class is absent. Midranks by argsort and segment means, O(n log n)."""
    p = np.asarray(probs, dtype=np.float64).reshape(-1)
    y = np.asarray(labels, dtype=np.float64).reshape(-1)
    n_pos = int(y.sum())
    n_neg = int(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(p, kind="mergesort")
    sp = p[order]
    # tie groups: start flags -> group index -> midrank = mean of 1-based ranks
    starts = np.concatenate([[True], sp[1:] != sp[:-1]])
    gidx = np.cumsum(starts) - 1
    counts = np.bincount(gidx)
    rank_sums = np.bincount(gidx, weights=np.arange(1, len(sp) + 1))
    midranks = np.empty(len(sp))
    midranks[order] = (rank_sums / counts)[gidx]
    return float(
        (midranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    )


def grouped_auc(probs, labels, group_ids, weighted: bool = True) -> float:
    """UAUC / GAUC: exact ROC AUC per group, averaged over the groups
    (weighted by their sizes by default). Groups without a positive or
    without a negative are skipped."""
    probs = np.asarray(probs, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    group_ids = np.asarray(group_ids).reshape(-1)
    total, weight_sum = 0.0, 0.0
    for g in np.unique(group_ids):
        m = group_ids == g
        auc = exact_auc(probs[m], labels[m])
        if auc != auc:  # NaN: group lacks a positive or a negative
            continue
        w = float(m.sum()) if weighted else 1.0
        total += w * auc
        weight_sum += w
    return total / weight_sum if weight_sum else float("nan")


def binary_classification_suite(
    probs: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5
) -> Dict[str, torch.Tensor]:
    """Accuracy, precision, recall, F1 and logloss of one batch."""
    probs = torch.as_tensor(probs).float()
    labels = torch.as_tensor(labels).float().to(probs.device)
    pred = (probs >= threshold).float()
    tp = (pred * labels).sum()
    fp = (pred * (1 - labels)).sum()
    fn = ((1 - pred) * labels).sum()
    precision = tp / (tp + fp).clamp_min(1.0)
    recall = tp / (tp + fn).clamp_min(1.0)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-8)
    eps = 1e-7
    p = probs.clamp(eps, 1 - eps)
    logloss = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()
    return {
        "accuracy": (pred == labels).float().mean(),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "logloss": logloss,
    }
