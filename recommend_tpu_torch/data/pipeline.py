"""Host-side batches: a copy of ``retrieval_batches``, ``ranking_batches``,
their shard helpers and ``prefetch`` from the JAX package's
``data/pipeline.py``.

Fixed-shape numpy batches, drop-remainder, a seeded permutation per epoch,
and histories left-padded (zeros at the front, validity False) so the most
recent items sit at the tail, where the retrieval tower's compression keeps
raw tokens and pyramid tail queries look. The same data and seed give the
same batches as the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.data.synthetic import SyntheticRankingData, SyntheticRetrievalData

FEATURE_KEYS = ("video_id", "category", "tag", "duration", "timestamp")


def _resolve_shard(
    num_shards: Optional[int], shard_id: Optional[int]
) -> Tuple[int, int]:
    """Default to one shard: every process of a mesh takes the same
    batches, and a mesh trainer keeps its rank's block of each (JAX's
    default, one shard per host process, is one shard on one host). Pass
    both or neither: a lone num_shards would feed every process shard 0."""
    if num_shards is None and shard_id is None:
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


def build_retrieval_examples(
    data: SyntheticRetrievalData,
    cfg: RetrievalConfig,
    min_history: int = 5,
    max_samples_per_user: Optional[int] = None,
) -> List[Tuple[int, int]]:
    """(user_idx, split_point) pairs: one training sample per prefix."""
    examples = []
    for u, seq in enumerate(data.user_sequences):
        n = len(seq["video_id"])
        points = list(range(min_history, n))
        if max_samples_per_user is not None and len(points) > max_samples_per_user:
            points = points[-max_samples_per_user:]
        examples.extend((u, t) for t in points)
    return examples


def _pad_history(
    seq: Dict[str, np.ndarray], end: int, max_len: int
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Take seq[:end], keep the most recent max_len, left-pad to max_len."""
    start = max(0, end - max_len)
    n = end - start
    out = {}
    for k in FEATURE_KEYS:
        dtype = np.float32 if k == "duration" else np.int64
        arr = np.zeros(max_len, dtype=dtype)
        arr[max_len - n :] = seq[k][start:end]
        out[k] = arr
    valid = np.zeros(max_len, dtype=bool)
    valid[max_len - n :] = True
    return out, valid


def retrieval_batches(
    data: SyntheticRetrievalData,
    cfg: RetrievalConfig,
    batch_size: int,
    seed: int = 0,
    num_epochs: Optional[int] = None,
    min_history: int = 5,
    use_native: bool = True,
    num_shards: Optional[int] = None,
    shard_id: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches:
    ``history``: dict of [B, L] feature arrays; ``history_valid``: [B, L] bool;
    ``target``: dict of [B] feature arrays for the positive item;
    ``target_popularity``: [B] sampling probability (for LogQ);
    ``history_popularity``: [B, L] sampling probability of each history item.

    With ``use_native`` every batch is assembled by the C++ batcher
    (``data/native.py``, built with g++ at first use; a failed build
    raises), otherwise by the numpy path below; the two give the same
    batches, as in the JAX package.

    ``num_shards``/``shard_id``: per-process disjoint strides of the same
    seeded permutation, as in ``ranking_batches``."""
    examples = build_retrieval_examples(data, cfg, min_history)
    probs = data.sampling_probs()
    rng = np.random.default_rng(seed)
    num_shards, shard_id = _resolve_shard(num_shards, shard_id)
    if use_native:
        from recommend_tpu_torch.data.native import (
            FlatSequences,
            fill_retrieval_batch,
            load_native,
        )

        lib = load_native()
        flat = FlatSequences(data.user_sequences)
        ex = np.asarray(examples, dtype=np.int64).reshape(-1, 2)

        def assemble(idx):
            return fill_retrieval_batch(lib, flat, ex[idx, 0], ex[idx, 1], cfg.max_seq_len,
                                        probs)
    else:
        def assemble(idx):
            hist = {k: np.zeros((batch_size, cfg.max_seq_len),
                                dtype=np.float32 if k == "duration" else np.int64)
                    for k in FEATURE_KEYS}
            valid = np.zeros((batch_size, cfg.max_seq_len), dtype=bool)
            tgt = {k: np.zeros(batch_size,
                               dtype=np.float32 if k == "duration" else np.int64)
                   for k in FEATURE_KEYS}
            pop = np.zeros(batch_size, dtype=np.float32)
            for b, e in enumerate(idx):
                u, t = examples[e]
                seq = data.user_sequences[u]
                h, v = _pad_history(seq, t, cfg.max_seq_len)
                for k in FEATURE_KEYS:
                    hist[k][b] = h[k]
                valid[b] = v
                for k in FEATURE_KEYS:
                    tgt[k][b] = seq[k][t]
                pop[b] = probs[seq["video_id"][t]]
            return {"history": hist, "history_valid": valid, "target": tgt,
                    "target_popularity": pop}

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = _shard_slice(rng.permutation(len(examples)), num_shards, shard_id)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batch = assemble(order[i : i + batch_size])
            batch["history_popularity"] = probs[batch["history"]["video_id"]]
            yield batch
        epoch += 1


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
