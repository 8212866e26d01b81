"""Offline ranking evaluation, a simulated A/B comparison and permutation
feature importance: the port of the JAX package's
``evaluation/ranking_eval.py``.

- ``evaluate``: per task the exact (tie-corrected) AUC, the streaming
  histogram AUC, accuracy / precision / recall / F1 / logloss at 0.5, the
  F1-maximizing operating point, the label and predicted-positive rates,
  UAUC over ``user_feature``, and the throughput. Each batch is timed from
  the forward's launch, its inputs already on the device, up to the
  device-to-host fetch of its probabilities.
- ``ab_test``: relative lifts, a two-proportion z-test on the primary
  task's predicted-positive rates and a bootstrap CI of its AUC lift.
- ``feature_importance``: the primary-task AUC drop when one feature column
  is shuffled across each batch.
- ``save_report`` (JSON) and ``save_charts`` (PNG; nothing when matplotlib
  is missing).

The model is any module with ``RankingModel``'s forward signature, run on
``params`` (its state dict) through ``torch.func.functional_call``; it may
sit on the meta device. The evaluator runs on CUDA unless given
``device="cpu"``; with no device given and no CUDA available it raises.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.training.metrics import (
    binary_classification_suite,
    exact_auc,
    grouped_auc,
    streaming_auc,
)


def _best_f1_operating_point(
    probs: np.ndarray, labels: np.ndarray, num_thresholds: int = 512
) -> Dict[str, float]:
    """The F1-maximizing threshold over quantile-spaced candidates, fit on
    the stream it reports on (an in-sample operating point)."""
    order = np.argsort(-probs, kind="stable")
    y = labels[order].astype(np.float64)
    tp_at = np.cumsum(y)  # tp when the top i+1 are predicted positive
    n_pos = float(y.sum())
    if n_pos == len(y) and len(y) > 0:
        # all positive: any threshold at or below min(probs) is perfect
        return {"threshold_best": float(probs.min()), "f1_best": 1.0,
                "precision_best": 1.0, "recall_best": 1.0}
    if n_pos == 0:
        return {"threshold_best": 0.5, "f1_best": 0.0,
                "precision_best": 0.0, "recall_best": 0.0}
    idx = np.unique(
        np.linspace(0, len(y) - 1, min(num_thresholds, len(y))).astype(np.int64)
    )
    tp = tp_at[idx]
    k = idx + 1.0
    precision = tp / k
    recall = tp / n_pos
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    best = int(np.argmax(f1))
    return {
        "threshold_best": float(probs[order][idx[best]]),
        "f1_best": float(f1[best]),
        "precision_best": float(precision[best]),
        "recall_best": float(recall[best]),
    }


class RankingEvaluator:
    def __init__(
        self,
        cfg: RankingConfig,
        model: torch.nn.Module,
        params: Mapping[str, torch.Tensor],
        user_feature: Optional[str] = "user_id",
        device=None,
    ):
        """``user_feature``: the non-sequence feature that groups
        predictions for UAUC; None (or a feature the config lacks) skips
        UAUC."""
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device, "RankingEvaluator")
        self.params = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
        self.user_feature = user_feature if user_feature in cfg.non_seq_features else None
        self._auc = streaming_auc(device=self.device)

    def _batch_args(self, batch):
        return tuple({k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in
                      batch[group].items()} for group in ("non_seq", "sequences", "seq_valid"))

    @torch.no_grad()
    def _probs(self, args) -> Dict[str, np.ndarray]:
        logits = functional_call(self.model, self.params, args)
        probs = torch.stack([torch.sigmoid(logits[t].float()) for t in self.cfg.tasks])
        p = probs.cpu().numpy()  # the batch's one device-to-host copy
        return {t: p[i] for i, t in enumerate(self.cfg.tasks)}

    def evaluate(self, batches: Iterable[Dict], return_arrays: bool = False) -> Dict[str, float]:
        """The offline suite. With ``return_arrays`` the report carries a
        ``_arrays`` entry {task: (probs, labels)} for ``ab_test``."""
        init, update, compute = self._auc
        tasks = self.cfg.tasks
        auc_states = {t: init() for t in tasks}
        probs_all = {t: [] for t in tasks}
        labels_all = {t: [] for t in tasks}
        users_all: List[np.ndarray] = []
        n, t_total = 0, 0.0
        for batch in batches:
            if self.user_feature is not None:
                users_all.append(np.asarray(batch["non_seq"][self.user_feature]))
            args = self._batch_args(batch)
            t0 = time.perf_counter()
            fetched = self._probs(args)
            t_total += time.perf_counter() - t0
            for t in tasks:
                y = np.asarray(batch["labels"][t])
                auc_states[t] = update(auc_states[t],
                                       torch.from_numpy(fetched[t]).to(self.device),
                                       torch.from_numpy(y).to(self.device))
                probs_all[t].append(fetched[t])
                labels_all[t].append(y)
            n += len(fetched[tasks[0]])
        out: Dict[str, float] = {"num_samples": n}
        if n:
            out["throughput_samples_per_s"] = n / max(t_total, 1e-9)
        arrays = {}
        for t in tasks:
            if not probs_all[t]:
                continue
            p_np = np.concatenate(probs_all[t])
            y_np = np.concatenate(labels_all[t])
            arrays[t] = (p_np, y_np)
            suite = binary_classification_suite(torch.from_numpy(p_np),
                                                 torch.from_numpy(y_np))
            out.update({f"{t}_{k}": float(v) for k, v in suite.items()})
            # the reported AUC is the exact one; the histogram's stays beside it
            out[f"{t}_auc"] = exact_auc(p_np, y_np)
            out[f"{t}_auc_streaming"] = float(compute(auc_states[t]))
            # predicted positives at 0.5, and the true base rate
            out[f"{t}_positive_rate"] = float(np.mean(p_np >= 0.5))
            out[f"{t}_label_rate"] = float(np.mean(y_np))
            best = _best_f1_operating_point(p_np, y_np)
            out.update({f"{t}_{k}": float(v) for k, v in best.items()})
            if users_all:
                out[f"{t}_uauc"] = grouped_auc(p_np, y_np, np.concatenate(users_all))
        if return_arrays:
            out["_arrays"] = arrays
        return out

    def ab_test(
        self,
        control_batches: Iterable[Dict],
        treatment_batches: Iterable[Dict],
        metric: Optional[str] = None,
        bootstrap_samples: int = 1000,
        seed: int = 0,
        bootstrap_sample_cap: int = 200_000,
    ) -> Dict[str, object]:
        """Control against treatment: relative lifts of every metric, a
        two-proportion z-test on the primary task's predicted-positive
        rates, and a bootstrap percentile CI of its AUC lift (each arm
        resampled on its own, after a seeded subsample to
        ``bootstrap_sample_cap`` rows)."""
        metric = metric or f"{self.cfg.tasks[0]}_auc"
        control = self.evaluate(control_batches, return_arrays=True)
        treatment = self.evaluate(treatment_batches, return_arrays=True)
        c_arrays = control.pop("_arrays")
        t_arrays = treatment.pop("_arrays")
        lifts = {
            k: (treatment[k] - control[k]) / abs(control[k])
            for k in control
            if k in treatment and isinstance(control[k], float) and control[k] != 0
        }
        t0 = self.cfg.tasks[0]
        p1, n1 = control.get(f"{t0}_positive_rate", 0.5), control["num_samples"]
        p2, n2 = treatment.get(f"{t0}_positive_rate", 0.5), treatment["num_samples"]
        pooled = (p1 * n1 + p2 * n2) / max(n1 + n2, 1)
        se = math.sqrt(max(pooled * (1 - pooled) * (1 / max(n1, 1) + 1 / max(n2, 1)), 1e-12))
        z = (p2 - p1) / se
        rng = np.random.default_rng(seed)
        diffs = []
        if t0 in c_arrays and t0 in t_arrays:  # either arm may be empty
            cp, cy = c_arrays[t0]
            tp, ty = t_arrays[t0]
            if len(cp) > bootstrap_sample_cap:
                keep = rng.choice(len(cp), bootstrap_sample_cap, replace=False)
                cp, cy = cp[keep], cy[keep]
            if len(tp) > bootstrap_sample_cap:
                keep = rng.choice(len(tp), bootstrap_sample_cap, replace=False)
                tp, ty = tp[keep], ty[keep]
            for _ in range(bootstrap_samples):
                ci = rng.integers(0, len(cp), len(cp))
                ti = rng.integers(0, len(tp), len(tp))
                a_c = exact_auc(cp[ci], cy[ci])
                a_t = exact_auc(tp[ti], ty[ti])
                if a_c == a_c and a_t == a_t:
                    diffs.append(a_t - a_c)
        diffs = np.asarray(diffs)
        lo, hi = (
            (float(np.percentile(diffs, 2.5)), float(np.percentile(diffs, 97.5)))
            if len(diffs) else (float("nan"), float("nan"))
        )
        return {
            "control": control,
            "treatment": treatment,
            "relative_lift": lifts,
            "primary_metric": metric,
            "primary_lift": lifts.get(metric, 0.0),
            "positive_rate_z_score": z,
            "positive_rate_significant_95": abs(z) > 1.96,
            "auc_lift_ci95": (lo, hi),
            "auc_lift_significant_95": bool(len(diffs)) and (lo > 0 or hi < 0),
        }

    def feature_importance(
        self,
        batches: List[Dict],
        features: Optional[List[str]] = None,
        seed: int = 0,
    ) -> Dict[str, float]:
        """Permutation importance: shuffle one feature column within each
        batch and report the primary-task AUC drop, largest first."""
        rng = np.random.default_rng(seed)
        t0 = self.cfg.tasks[0]
        base_auc = self.evaluate(iter(batches))[f"{t0}_auc"]
        out = {}
        for f in features or list(self.cfg.non_seq_features):
            permuted = []
            for batch in batches:
                col = np.asarray(batch["non_seq"][f])
                permuted.append({**batch, "non_seq": {**batch["non_seq"],
                                                      f: col[rng.permutation(len(col))]}})
            out[f] = float(base_auc - self.evaluate(iter(permuted))[f"{t0}_auc"])
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    @staticmethod
    def save_report(report: Dict, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"timestamp": time.time(), **report}, f, indent=2, default=float)

    def save_charts(self, report: Dict, out_dir: str) -> List[str]:
        """PNG bars of each task's metrics, and of the feature importance
        when the report has it. Writes nothing, and returns [], when
        matplotlib is missing."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return []
        os.makedirs(out_dir, exist_ok=True)
        written = []

        def bars(names, values, title, filename):
            fig, ax = plt.subplots(figsize=(7, 3.5))
            ax.bar(names, values)
            ax.set_title(title)
            ax.tick_params(axis="x", rotation=30)
            p = os.path.join(out_dir, filename)
            fig.tight_layout()
            fig.savefig(p)
            plt.close(fig)
            written.append(p)

        for t in self.cfg.tasks:
            keys = [k for k in report if k.startswith(f"{t}_")]
            if keys:
                bars([k[len(t) + 1:] for k in keys], [float(report[k]) for k in keys],
                     f"{t} metrics", f"{t}_metrics.png")
        fi = report.get("feature_importance")
        if isinstance(fi, dict) and fi:
            bars(list(fi), [float(v) for v in fi.values()],
                 "permutation feature importance (AUC drop)", "feature_importance.png")
        return written
