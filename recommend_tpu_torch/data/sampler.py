"""Negative sampling: a copy of the JAX package's ``data/sampler.py``
(numpy only).

Popularity-weighted (or uniform) sampling without replacement, with an
exclusion list (e.g. the videos a user has already seen). The same seed
gives the same draws as the JAX package's sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class NegativeSampler:
    def __init__(
        self,
        popularity: np.ndarray,
        strategy: str = "popularity",
        seed: int = 0,
    ):
        assert strategy in ("popularity", "uniform")
        self.num_items = len(popularity)
        self.strategy = strategy
        p = popularity.astype(np.float64)
        self.probs = p / p.sum()
        self.rng = np.random.default_rng(seed)

    def sample_negatives(
        self, num: int, positive: Optional[int] = None
    ) -> np.ndarray:
        """Sample `num` distinct item ids, excluding the positive."""
        exclude = [] if positive is None else [positive]
        return self.sample_negatives_with_exclusion(num, exclude)

    def sample_negatives_with_exclusion(
        self, num: int, exclude: Sequence[int]
    ) -> np.ndarray:
        """Without-replacement sampling avoiding `exclude`."""
        if self.strategy == "popularity":
            p = self.probs.copy()
            if len(exclude):
                p[np.asarray(exclude, dtype=np.int64)] = 0.0
            p = p / p.sum()
            return self.rng.choice(self.num_items, size=num, replace=False, p=p)
        candidates = np.setdiff1d(
            np.arange(self.num_items), np.asarray(exclude, dtype=np.int64),
            assume_unique=False,
        )
        return self.rng.choice(candidates, size=num, replace=False)
