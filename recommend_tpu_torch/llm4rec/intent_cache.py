"""Intent-generation cache — offline LLM feature producer plumbing: a copy
of the JAX package's ``llm4rec/intent_cache.py`` (stdlib and numpy only;
here every count in ``stats`` is updated under the cache's lock, since the
async miss path counts from its own thread).

Capability parity with `llm4rec/intent_generate/readme.md:7-26`: user intents
(4 axes: category / topic / content / content-form) are produced by a
fine-tuned LLM *offline*; serving reads a cache with:
  - batch precompute for low-frequency users,
  - online incremental update on cache miss (bounded-latency: miss returns a
    default and enqueues the user for async generation),
  - staleness-based refresh.

The LLM itself is a pluggable callable (`generator(user_payload) -> intent`)
— in production a served model endpoint, in tests a stub. This module is the
host-side subsystem; generated intents flow into the ranking model as
semantic NS-token features (config.semantic_features).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class IntentCache:
    def __init__(
        self,
        generator: Callable[[Any], np.ndarray],
        default_intent: np.ndarray,
        capacity: int = 100_000,
        max_age_s: float = 3600.0,
        async_updates: bool = True,
    ):
        self.generator = generator
        self.default_intent = np.asarray(default_intent)
        self.capacity = capacity
        self.max_age_s = max_age_s
        self.async_updates = async_updates
        self._store: "OrderedDict[Any, tuple]" = OrderedDict()  # id → (intent, ts)
        self._lock = threading.Lock()
        self._pending: set = set()
        self.stats = {"hits": 0, "misses": 0, "refreshes": 0, "generated": 0}

    # -- batch precompute (low-frequency users, readme:20) ------------------
    def precompute(self, user_payloads: Dict[Any, Any]) -> None:
        for uid, payload in user_payloads.items():
            self._put(uid, self.generator(payload), generated=True)

    # -- online path --------------------------------------------------------
    def get(self, user_id: Any, payload: Any = None) -> np.ndarray:
        """Bounded-latency read: hit → cached intent; miss → default intent
        (+ async generation when a payload is supplied)."""
        with self._lock:
            entry = self._store.get(user_id)
            if entry is not None:
                intent, ts = entry
                self._store.move_to_end(user_id)
                if time.time() - ts <= self.max_age_s:
                    self.stats["hits"] += 1
                    return intent
                self.stats["refreshes"] += 1
            else:
                self.stats["misses"] += 1
        if payload is not None:
            if self.async_updates:
                self._enqueue(user_id, payload)
            else:
                intent = self.generator(payload)
                self._put(user_id, intent, generated=True)
                return intent
        with self._lock:
            entry = self._store.get(user_id)
        return entry[0] if entry is not None else self.default_intent

    def _enqueue(self, user_id: Any, payload: Any) -> None:
        with self._lock:
            if user_id in self._pending:
                return
            self._pending.add(user_id)

        def work():
            try:
                self._put(user_id, self.generator(payload), generated=True)
            finally:
                with self._lock:
                    self._pending.discard(user_id)

        threading.Thread(target=work, daemon=True).start()

    def _put(self, user_id: Any, intent: np.ndarray, generated: bool = False) -> None:
        with self._lock:
            self.stats["generated"] += generated
            self._store[user_id] = (np.asarray(intent), time.time())
            self._store.move_to_end(user_id)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def batch_get(self, user_ids: Sequence[Any]) -> np.ndarray:
        """[len(ids), intent_dim] matrix for feeding semantic NS features."""
        return np.stack([self.get(u) for u in user_ids])

    def __len__(self) -> int:
        return len(self._store)
