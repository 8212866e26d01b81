"""Full-corpus retrieval evaluation: the port of the JAX package's
``evaluation/retrieval_eval.py``.

- ``evaluate_retrieval``: Recall@{1,5,10,50,100}, NDCG@{10,50,100}, MRR and
  MAP over the whole corpus, each (history -> target) pair ranked by the
  index's exact top-k scan.
- ``evaluate_classification``: AUC (the streaming histogram) and average
  precision of the positive item against popularity-sampled negatives.
- ``benchmark_latency``: p50/p95/p99 of forward + search on a batch put on
  the device once, each call ending in the search's host copy;
  ``save_results`` (JSON).

The evaluator runs on CUDA unless given ``device="cpu"``; with no device
given and no CUDA available it raises. ``mesh`` goes to the index, whose
corpus it row-shards (``serving/retrieval_service.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.data.synthetic import SyntheticRetrievalData
from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
from recommend_tpu_torch.training.metrics import streaming_auc


class RetrievalEvaluator:
    def __init__(
        self,
        cfg: RetrievalConfig,
        params: Mapping[str, torch.Tensor],
        mesh=None,
        device=None,
    ):
        """``params``: a state dict of ``RetrievalTower(cfg)``; ``mesh``: the
        index's (the evaluator runs on the mesh's device)."""
        self.cfg = cfg
        self.device = resolve_device(device if mesh is None else mesh.device,
                                     "RetrievalEvaluator")
        self.index = RetrievalIndex(cfg, params, mesh=mesh, device=self.device)
        self.model = self.index.model

    def _put(self, features: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in features.items()}

    def _put_history(self, batch: Mapping) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(history features, history validity) of a host batch, on the
        device."""
        return self._put(batch["history"]), self._put(
            {"valid": batch["history_valid"]})["valid"]

    @torch.no_grad()
    def _interests(self, batch: Mapping) -> torch.Tensor:
        return self.model(*self._put_history(batch))

    def evaluate_retrieval(
        self,
        data: SyntheticRetrievalData,
        batches: Iterable[Dict],
        ks: Tuple[int, ...] = (1, 5, 10, 50, 100),
        max_k: Optional[int] = None,
    ) -> Dict[str, float]:
        """Full-corpus metrics: for each (history -> target) pair, retrieve
        the top max(ks) of the whole corpus and score the target's rank.
        A batch may carry ``num_real`` (< batch size) to mark padded
        duplicate rows at its end; those are left out of every metric."""
        if self.index.item_embeddings is None:
            self.index.build(data.corpus_features())
        kmax = max_k or max(ks)
        kmax = min(kmax, self.index.num_items)
        hits = {k: [] for k in ks if k <= kmax}
        ndcgs = {k: [] for k in ks if k <= kmax}
        rrs: List[float] = []
        for batch in batches:
            _, ids = self.index.search(self._interests(batch), kmax)  # [B, kmax]
            targets = np.asarray(batch["target"]["video_id"])
            num_real = int(batch.get("num_real", len(targets)))
            ids, targets = ids[:num_real], targets[:num_real]
            for row_ids, t in zip(ids, targets):
                pos = np.nonzero(row_ids == t)[0]
                rank = int(pos[0]) if len(pos) else kmax
                for k in hits:
                    hits[k].append(1.0 if rank < k else 0.0)
                    ndcgs[k].append(1.0 / np.log2(rank + 2) if rank < k else 0.0)
                rrs.append(1.0 / (rank + 1) if rank < kmax else 0.0)
        out = {}
        for k in hits:
            out[f"recall@{k}"] = float(np.mean(hits[k]))
            out[f"ndcg@{k}"] = float(np.mean(ndcgs[k]))
        out["mrr"] = float(np.mean(rrs))
        out["map"] = out["mrr"]  # one relevant item per query: MAP == MRR
        return out

    @torch.no_grad()
    def evaluate_classification(
        self,
        data: SyntheticRetrievalData,
        batches: Iterable[Dict],
        num_negatives: int = 100,
        seed: int = 0,
    ) -> Dict[str, float]:
        """AUC / average precision of the positive item against
        ``num_negatives`` popularity-sampled negatives per row. Scores pass
        through a sigmoid after division by their (population) std, which
        leaves the AUC as it is, into the streaming histogram."""
        rng = np.random.default_rng(seed)
        probs = data.sampling_probs()
        corpus = data.corpus_features()
        init, update, compute = streaming_auc(device=self.device)
        auc_state = init()
        ap_num, ap_den = 0.0, 0
        for batch in batches:
            interests = self._interests(batch).float()  # [B, k, D]
            b = interests.shape[0]
            pos_emb = self.model.item_embeddings(self._put(batch["target"])).float()
            neg_ids = rng.choice(len(probs), size=(b, num_negatives), p=probs)
            neg_emb = self.model.item_embeddings(
                self._put({k: corpus[k][neg_ids] for k in corpus})).float()  # [B, N, D]
            s_pos = torch.einsum("bkd,bd->bk", interests, pos_emb).amax(dim=1)  # [B]
            s_neg = torch.einsum("bkd,bnd->bkn", interests, neg_emb).amax(dim=1)  # [B, N]
            scores = torch.cat([s_pos[:, None], s_neg], dim=1)
            labels = torch.cat([torch.ones((b, 1), device=self.device),
                                torch.zeros((b, num_negatives), device=self.device)], dim=1)
            p = torch.sigmoid(scores / scores.std(correction=0).clamp_min(1e-6))
            auc_state = update(auc_state, p.reshape(-1), labels.reshape(-1))
            # average precision of a single positive = 1 / rank
            rank = (s_neg > s_pos[:, None]).sum(dim=1) + 1
            ap_num += float((1.0 / rank).sum())
            ap_den += b
        return {
            "auc": float(compute(auc_state)),
            "average_precision": ap_num / max(ap_den, 1),
        }

    def benchmark_latency(
        self,
        batch: Dict,
        n_iters: int = 50,
        warmup: int = 5,
    ) -> Dict[str, float]:
        """p50/p95/p99 end-to-end (forward + search) latency, host clock;
        each call ends in the search's device-to-host copy. The batch goes
        to the device once, before the warm-up, as in the JAX package: the
        timed calls do not copy it."""
        bsz = len(batch["history_valid"])
        k = min(self.cfg.top_k, self.index.num_items)
        feats, valid = self._put_history(batch)

        @torch.no_grad()
        def once():
            return self.index.search(self.model(feats, valid), k)

        for _ in range(warmup):
            once()
        lats = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            once()
            lats.append((time.perf_counter() - t0) * 1000)
        lats = np.asarray(lats)
        return {
            "batch_size": bsz,
            "latency_ms_p50": float(np.percentile(lats, 50)),
            "latency_ms_p95": float(np.percentile(lats, 95)),
            "latency_ms_p99": float(np.percentile(lats, 99)),
            "latency_ms_mean": float(lats.mean()),
            "throughput_qps": float(bsz * 1000.0 / lats.mean()),
        }

    @staticmethod
    def save_results(results: Dict, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"timestamp": time.time(), **results}, f, indent=2)
