"""Seeded synthetic ranking data: a copy of the ranking half of the JAX
package's ``data/synthetic.py`` (numpy only; the retrieval half comes with
the retrieval slice).

Categorical ids per feature, three behavior sequences of random length
(left-padded with id 0), and Bernoulli CTR/CVR labels whose CTR depends on
observable features (CVR only when CTR = 1). The same seed gives the same
arrays as the JAX package's ``make_ranking_data``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from recommend_tpu_torch.config import RankingConfig


@dataclasses.dataclass
class SyntheticRankingData:
    """Flat feature table + behavior sequences + multi-task labels."""

    non_seq: Dict[str, np.ndarray]  # categorical id per feature: [N]
    sequences: Dict[str, np.ndarray]  # per seq-feature: ids [N, L]
    seq_lengths: Dict[str, np.ndarray]  # per seq-feature: [N]
    labels: Dict[str, np.ndarray]  # per task: [N] float {0,1}

    @property
    def num_samples(self) -> int:
        return len(next(iter(self.labels.values())))


def make_ranking_data(
    cfg: RankingConfig,
    num_samples: int = 1000,
    max_seq_per_feature: int = 64,
    seed: int = 0,
) -> SyntheticRankingData:
    rng = np.random.default_rng(seed)
    non_seq = {
        f: rng.integers(0, cfg.vocab_size(f), num_samples).astype(np.int32)
        for f in cfg.non_seq_features
    }
    item_vocab = cfg.vocab_size("item_id")
    sequences, seq_lengths = {}, {}
    for sf in cfg.sequence_features:
        lens = rng.integers(1, max_seq_per_feature + 1, num_samples).astype(np.int32)
        ids = rng.integers(0, item_vocab, (num_samples, max_seq_per_feature)).astype(np.int32)
        # left-pad convention: zero out positions before (max - len)
        mask = np.arange(max_seq_per_feature)[None, :] >= (max_seq_per_feature - lens[:, None])
        sequences[sf] = np.where(mask, ids, 0)
        seq_lengths[sf] = lens

    def norm_feat(name: str) -> np.ndarray:
        return non_seq[name].astype(np.float64) / cfg.vocab_size(name) - 0.5

    logit = -1.0
    weights = {"price_bucket": -2.0, "hour": 1.5, "category": 1.0, "age_bucket": 1.0}
    for f, w in weights.items():
        if f in non_seq:
            logit = logit + w * norm_feat(f)
    logit = logit + rng.normal(0, 0.5, num_samples)  # irreducible noise
    p_ctr = 1.0 / (1.0 + np.exp(-logit))
    ctr = (rng.random(num_samples) < p_ctr).astype(np.float32)
    labels = {}
    for t in cfg.tasks:
        if t == "ctr":
            labels[t] = ctr
        elif t == "cvr":
            labels[t] = ctr * (rng.random(num_samples) < 0.2).astype(np.float32)
        else:
            labels[t] = (rng.random(num_samples) < 0.5).astype(np.float32)
    return SyntheticRankingData(non_seq, sequences, seq_lengths, labels)
