"""Ranking inference engine: truncate/left-pad preprocessing, single and
batch inference, latency and success stats, and the cross-candidate KV cache
(``score_request`` encodes the behavior sequences once, then scores every
candidate through the NS-only path).

Candidate counts are padded to powers of two, as in the JAX engine, so a
request scores the same rows there and here. Probabilities come back stacked
[T, B] in one device-to-host copy per request.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
device given and no CUDA available it raises.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.models.ranking import RankingModel

Tensors = Dict[str, torch.Tensor]


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class RankingInferenceEngine:
    def __init__(
        self,
        cfg: RankingConfig,
        params: Mapping[str, torch.Tensor],
        max_seq_len: int = 64,
        device=None,
    ):
        """``params``: a state dict of ``RankingModel(cfg)`` (from
        ``convert.params_from_flax`` or ``convert.init_params``)."""
        self.cfg = cfg
        self.device = resolve_device(device, "RankingInferenceEngine")
        with torch.device("meta"):
            model = RankingModel(cfg)
        model.load_state_dict(
            {k: torch.as_tensor(v).to(self.device) for k, v in params.items()},
            assign=True,
        )
        self.model = model.eval().requires_grad_(False)
        self.max_seq_len = max_seq_len
        self.stats_state = {
            "total": 0, "success": 0, "failure": 0, "ema_latency_ms": None,
        }
        self._latencies: deque = deque(maxlen=1000)

    # -- preprocessing ------------------------------------------------------
    def _to_device(self, arr: np.ndarray, names: Sequence[str]) -> Tensors:
        """One host-to-device copy of a stacked [F, ...] array, split by
        feature."""
        t = torch.from_numpy(arr).to(self.device)
        return {name: t[i] for i, name in enumerate(names)}

    def _sequence_arrays(
        self, rows: Sequence[Mapping[str, Sequence[int]]]
    ) -> Tuple[Tensors, Tensors]:
        """Truncate (keep the most recent) and left-pad each behavior
        sequence of each row -> ([B, max_seq_len] ids, validity) per
        feature."""
        l, names = self.max_seq_len, self.cfg.sequence_features
        ids = np.zeros((len(names), len(rows), l), dtype=np.int64)
        valid = np.zeros((len(names), len(rows), l), dtype=bool)
        for i, sf in enumerate(names):
            for r, seqs in enumerate(rows):
                items = list(seqs.get(sf, ()))[-l:]
                if items:
                    ids[i, r, l - len(items):] = items
                    valid[i, r, l - len(items):] = True
        return self._to_device(ids, names), self._to_device(valid, names)

    def preprocess_sequences(
        self, sequences: Mapping[str, Sequence[int]]
    ) -> Tuple[Tensors, Tensors]:
        """Truncate (keep the most recent) and left-pad each behavior
        sequence -> [1, max_seq_len] ids and validity on the device."""
        return self._sequence_arrays([sequences])

    def _non_seq_arrays(self, rows: List[Mapping[str, int]]) -> Tensors:
        names = self.cfg.non_seq_features
        arr = np.array([[r.get(f, 0) for r in rows] for f in names], dtype=np.int64)
        return self._to_device(arr, names)

    # -- device paths -------------------------------------------------------
    def _stack(self, logits: Tensors) -> torch.Tensor:
        return torch.stack([torch.sigmoid(logits[t]) for t in self.cfg.tasks])

    def _probs_fwd(self, ns: Tensors, seqs: Tensors, sv: Tensors) -> torch.Tensor:
        return self._stack(self.model(ns, seqs, sv))

    def _probs_request(self, user_context, sequences, candidates) -> torch.Tensor:
        """[T, bucket] probabilities of one request, left on the device."""
        seqs, sv = self.preprocess_sequences(sequences)
        b = _bucket(len(candidates))
        cand = list(candidates) + [candidates[-1]] * (b - len(candidates))
        ns = self._non_seq_arrays([dict(user_context, **c) for c in cand])
        if self.cfg.use_kv_cache:
            cache = self.model.encode_s(seqs, sv)
            return self._stack(self.model.score_with_cache(cache, ns))
        tiled = {sf: v.expand(b, -1) for sf, v in seqs.items()}
        tiled_v = {sf: v.expand(b, -1) for sf, v in sv.items()}
        return self._probs_fwd(ns, tiled, tiled_v)

    def _rows(self, probs: torch.Tensor, n: int) -> List[Dict[str, float]]:
        p = probs.cpu().numpy()  # the request's one device-to-host copy
        return [{t: float(p[j][i]) for j, t in enumerate(self.cfg.tasks)}
                for i in range(n)]

    # -- inference ----------------------------------------------------------
    @torch.inference_mode()
    def single_inference(
        self,
        features: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
    ) -> Dict[str, float]:
        """features: merged user/item/context dict -> per-task probabilities."""
        t0 = time.perf_counter()
        try:
            seqs, sv = self.preprocess_sequences(sequences)
            ns = self._non_seq_arrays([features])
            out = self._rows(self._probs_fwd(ns, seqs, sv), 1)[0]
            self._record(t0, ok=True)
            return out
        except Exception:
            self._record(t0, ok=False)
            raise

    @torch.inference_mode()
    def batch_inference(
        self,
        rows: List[Tuple[Mapping[str, int], Mapping[str, Sequence[int]]]],
    ) -> List[Dict[str, float]]:
        """Independent (features, sequences) rows, padded to one bucket."""
        t0 = time.perf_counter()
        n = len(rows)
        rows = list(rows) + [rows[-1]] * (_bucket(n) - n)
        ns = self._non_seq_arrays([r[0] for r in rows])
        seqs, sv = self._sequence_arrays([r[1] for r in rows])
        out = self._rows(self._probs_fwd(ns, seqs, sv), n)
        self._record(t0, ok=True)
        return out

    @torch.inference_mode()
    def score_request(
        self,
        user_context: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
        candidates: List[Mapping[str, int]],
    ) -> List[Dict[str, float]]:
        """KV-cached request scoring: S side once, NS side per candidate.

        ``user_context``: user and context feature values shared by the
        candidates; ``candidates``: per-candidate item feature dicts.
        ``cfg.use_kv_cache`` off runs the full forward per candidate."""
        t0 = time.perf_counter()
        out = self._rows(
            self._probs_request(user_context, sequences, candidates),
            len(candidates),
        )
        self._record(t0, ok=True)
        return out

    @torch.inference_mode()
    def score_request_device(
        self,
        user_context: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
        candidates: List[Mapping[str, int]],
    ) -> torch.Tensor:
        """``score_request`` without the host copy: the [T, bucket]
        probabilities on the device. Stats are not recorded."""
        return self._probs_request(user_context, sequences, candidates)

    def warmup(self, n_candidates: int = 1) -> None:
        """Run each request path once (batch forward and the KV-cached
        request) before live traffic: the first call loads the kernel
        library and initializes the CUDA libraries."""
        cfg = self.cfg
        user = {f: 0 for f in cfg.user_features + cfg.context_features}
        cands = [{f: 0 for f in cfg.item_features}] * max(n_candidates, 1)
        seqs = {sf: [1, 2] for sf in cfg.sequence_features}
        self.batch_inference([(dict(user, **cands[0]), seqs)])
        self.score_request(user, seqs, cands)

    # -- stats ----------------------------------------------------------------
    def _record(self, t0: float, ok: bool) -> None:
        dt_ms = (time.perf_counter() - t0) * 1000.0
        s = self.stats_state
        s["total"] += 1
        s["success" if ok else "failure"] += 1
        ema = s["ema_latency_ms"]
        s["ema_latency_ms"] = dt_ms if ema is None else 0.9 * ema + 0.1 * dt_ms
        self._latencies.append(dt_ms)

    def stats(self) -> Dict[str, float]:
        s = dict(self.stats_state)
        lats = np.asarray(self._latencies)
        if len(lats):
            s.update(
                latency_ms_p50=float(np.percentile(lats, 50)),
                latency_ms_p95=float(np.percentile(lats, 95)),
                latency_ms_p99=float(np.percentile(lats, 99)),
                success_rate=s["success"] / max(s["total"], 1),
                est_qps=1000.0 / max(float(np.mean(lats)), 1e-9),
            )
        return s
