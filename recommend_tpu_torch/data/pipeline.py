"""Host-side ranking batches: a copy of ``ranking_batches``, its shard
helpers and ``prefetch`` from the JAX package's ``data/pipeline.py``.

Fixed-shape numpy batches, drop-remainder, a seeded permutation per epoch,
and histories left-padded (zeros at the front, validity False) so the most
recent items sit at the tail, where pyramid tail queries look. The same data
and seed give the same batches as the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.data.synthetic import SyntheticRankingData


def _resolve_shard(
    num_shards: Optional[int], shard_id: Optional[int]
) -> Tuple[int, int]:
    """Default the data shard to this process's rank in an initialized
    ``torch.distributed`` group (one shard without one). Pass both or
    neither: a lone num_shards would feed every process shard 0."""
    if num_shards is None and shard_id is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            num_shards, shard_id = dist.get_world_size(), dist.get_rank()
        else:
            num_shards, shard_id = 1, 0
    if (num_shards is None) != (shard_id is None):
        raise ValueError("pass BOTH num_shards and shard_id, or neither")
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
    return num_shards, shard_id


def _shard_slice(order: np.ndarray, num_shards: int, shard_id: int) -> np.ndarray:
    """Disjoint per-shard stride, truncated to a common length, so every
    process yields the same number of batches per epoch."""
    per = len(order) // num_shards
    return order[shard_id::num_shards][:per]


def ranking_batches(
    data: SyntheticRankingData,
    cfg: RankingConfig,
    batch_size: int,
    seed: int = 0,
    num_epochs: Optional[int] = None,
    num_shards: Optional[int] = None,
    shard_id: Optional[int] = None,
) -> Iterator[Dict[str, object]]:
    """Yields batches:
    ``non_seq``: dict feature -> [B] int ids;
    ``sequences``: dict seq-feature -> [B, L] int ids (left-padded);
    ``seq_valid``: dict seq-feature -> [B, L] bool;
    ``labels``: dict task -> [B] float."""
    n = data.num_samples
    rng = np.random.default_rng(seed)
    num_shards, shard_id = _resolve_shard(num_shards, shard_id)
    widths = {sf: a.shape[1] for sf, a in data.sequences.items()}
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = _shard_slice(rng.permutation(n), num_shards, shard_id)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            seq_valid = {
                sf: np.arange(widths[sf])[None, :]
                >= (widths[sf] - data.seq_lengths[sf][idx][:, None])
                for sf in data.sequences
            }
            yield {
                "non_seq": {f: a[idx] for f, a in data.non_seq.items()},
                "sequences": {sf: a[idx] for sf, a in data.sequences.items()},
                "seq_valid": seq_valid,
                "labels": {t: a[idx] for t, a in data.labels.items()},
            }
        epoch += 1


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Assemble the next ``size`` batches on a background thread while the
    caller works on the current one."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item
