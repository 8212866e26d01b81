"""Seeded synthetic data: a copy of the JAX package's ``data/synthetic.py``
(numpy only).

- Retrieval: a video corpus (category, tag, duration) with Poisson(10) + 1
  popularity, and per-user watch sequences of length 10-50 drawn by
  popularity, or, with ``structured=True``, ~85% from a few preferred
  categories per user.
- Ranking: categorical ids per feature, three behavior sequences of random
  length (left-padded with id 0), and Bernoulli CTR/CVR labels whose CTR
  depends on observable features (CVR only when CTR = 1).

The same seed gives the same arrays as the JAX package's factories: the
numpy draws are the same, in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig


@dataclasses.dataclass
class SyntheticRetrievalData:
    """Video corpus + per-user behavior sequences."""

    video_features: Dict[str, np.ndarray]  # per-video: category, tag, duration
    popularity: np.ndarray  # [V] raw counts
    user_sequences: List[Dict[str, np.ndarray]]  # per-user dict of [L_u] arrays

    @property
    def num_videos(self) -> int:
        return len(self.popularity)

    def sampling_probs(self) -> np.ndarray:
        p = self.popularity.astype(np.float64)
        return (p / p.sum()).astype(np.float32)

    def corpus_features(self) -> Dict[str, np.ndarray]:
        """Feature dict for every video in the corpus (candidate tower input)."""
        v = np.arange(self.num_videos, dtype=np.int32)
        return {
            "video_id": v,
            "category": self.video_features["category"],
            "tag": self.video_features["tag"],
            "duration": self.video_features["duration"],
            "timestamp": np.zeros_like(v),
        }


def make_retrieval_data(
    cfg: RetrievalConfig,
    num_users: int = 1000,
    num_videos: int = 10_000,
    min_seq: int = 10,
    max_seq: int = 50,
    seed: int = 0,
    structured: bool = False,
    num_interest_categories: int = 50,
    interests_per_user: int = 3,
) -> SyntheticRetrievalData:
    """Popularity-weighted iid sequences; ``structured=True`` gives each user
    a few preferred categories and draws ~85% of watches from them
    (popularity-weighted within a category), so that held-out next-item
    prediction is learnable."""
    rng = np.random.default_rng(seed)
    num_videos = min(num_videos, cfg.video_vocab_size)
    n_cat = min(
        num_interest_categories if structured else cfg.category_vocab_size,
        cfg.category_vocab_size,
    )
    video_features = {
        "category": rng.integers(0, n_cat, num_videos).astype(np.int32),
        "tag": rng.integers(0, cfg.tag_vocab_size, num_videos).astype(np.int32),
        "duration": rng.uniform(5.0, cfg.max_duration_s, num_videos).astype(np.float32),
    }
    popularity = (rng.poisson(10.0, num_videos) + 1).astype(np.float32)
    p = popularity / popularity.sum()
    # per-category video pools + within-category popularity
    if structured:
        pools = []
        for c in range(n_cat):
            vids_c = np.nonzero(video_features["category"] == c)[0]
            pc = p[vids_c]
            pools.append((vids_c, pc / pc.sum() if len(vids_c) else None))
    user_sequences = []
    base_ts = 1_700_000_000
    for _ in range(num_users):
        n = int(rng.integers(min_seq, max_seq + 1))
        if structured:
            prefs = rng.choice(n_cat, size=interests_per_user, replace=False)
            vids = np.empty(n, dtype=np.int32)
            for i in range(n):
                if rng.random() < 0.85:
                    c = int(rng.choice(prefs))
                    vids_c, pc = pools[c]
                    if pc is None:
                        vids[i] = rng.choice(num_videos, p=p)
                        continue
                    vids[i] = rng.choice(vids_c, p=pc)
                else:
                    vids[i] = rng.choice(num_videos, p=p)
        else:
            vids = rng.choice(num_videos, size=n, replace=True, p=p).astype(np.int32)
        ts = base_ts + np.sort(rng.integers(0, 86_400 * 30, n)).astype(np.int64)
        user_sequences.append(
            {
                "video_id": vids.astype(np.int32),
                "category": video_features["category"][vids],
                "tag": video_features["tag"][vids],
                "duration": video_features["duration"][vids],
                "timestamp": ts,
            }
        )
    return SyntheticRetrievalData(video_features, popularity, user_sequences)


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
