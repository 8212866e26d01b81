"""Latency percentiles, device memory and MFU: the port of the JAX package's
``evaluation/benchmark.py``.

Every timed call ends in ``torch.cuda.synchronize`` and a host fetch of its
result, so a time covers the device work the call queued. ``mfu`` divides by
the port's own peak table, which holds NVIDIA's datasheet dense bf16 figure
for the H100 SXM and nothing else: the row is picked from
``torch.cuda.get_device_name()`` and an unknown card raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.models.ranking import pyramid_keep_lengths

# dense bf16 tensor-core peak (FLOP/s) by the name the card reports; the H100
# SXM5 reports itself as "NVIDIA H100 80GB HBM3" (NVIDIA H100 datasheet:
# 989.4 TFLOP/s bf16 dense, SXM)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


def peak_flops(device_name: Optional[str] = None) -> float:
    """The dense bf16 peak of the card named ``device_name`` (by default
    CUDA device 0's); raises for a card not in ``PEAK_BF16_FLOPS``."""
    name = torch.cuda.get_device_name(0) if device_name is None else device_name
    if name not in PEAK_BF16_FLOPS:
        raise KeyError(f"no peak for {name!r}; known: {sorted(PEAK_BF16_FLOPS)}")
    return PEAK_BF16_FLOPS[name]


def _first_leaf(x):
    if isinstance(x, dict):
        return _first_leaf(next(iter(x.values()))) if x else None
    if isinstance(x, (list, tuple)):
        return _first_leaf(x[0]) if x else None
    return x


def _sync(x, device: torch.device) -> None:
    """Wait for the device, then fetch one value of ``x`` to the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    leaf = _first_leaf(x)
    if isinstance(leaf, torch.Tensor):
        leaf.reshape(-1)[:1].cpu()
    elif leaf is not None:
        float(leaf)


def device_memory_stats(device=None) -> Dict[str, float]:
    """The caching allocator's memory in MB (in use, peak, the card's total),
    or {} for a device without one (the CPU)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    mb = 1024.0 * 1024.0
    stats = torch.cuda.memory_stats(device)
    return {
        "memory_source": "allocator",
        "memory_in_use_mb": stats.get("allocated_bytes.all.current", 0) / mb,
        "memory_peak_mb": stats.get("allocated_bytes.all.peak", 0) / mb,
        "memory_limit_mb": torch.cuda.get_device_properties(device).total_memory / mb,
    }


def latency_benchmark(
    fn: Callable[[], object],
    n_iters: int = 50,
    warmup: int = 5,
    batch_size: int = 1,
    device=None,
) -> Dict[str, float]:
    """Host-clock latency percentiles of ``fn()`` on ``device`` (CUDA unless
    told otherwise; raises without it), each call synchronized and fetched,
    with the allocator's memory after the timed calls and its change over
    them."""
    device = resolve_device(device, "latency_benchmark")
    for _ in range(warmup):
        _sync(fn(), device)
    mem_before = device_memory_stats(device)
    lats = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        _sync(fn(), device)
        lats.append((time.perf_counter() - t0) * 1000)
    lats = np.asarray(lats)
    out = {
        "latency_ms_p50": float(np.percentile(lats, 50)),
        "latency_ms_p95": float(np.percentile(lats, 95)),
        "latency_ms_p99": float(np.percentile(lats, 99)),
        "latency_ms_mean": float(lats.mean()),
        "throughput_per_s": float(batch_size * 1000.0 / lats.mean()),
    }
    mem_after = device_memory_stats(device)
    if mem_after:
        out.update(mem_after)
        out["memory_delta_mb"] = mem_after["memory_in_use_mb"] - mem_before["memory_in_use_mb"]
    return out


def ranking_model_flops(cfg, s_len: int, training: bool = False) -> float:
    """Analytic FLOPs per sample of the ranking forward (2 per MAC) with
    ``s_len`` S tokens; a training step counts 3x (backward = 2x forward)."""
    d, f, n = cfg.embed_dim, cfg.ffn_dim, cfg.num_ns_tokens
    total = s_len + n
    macs = 0.0
    # tokenizer
    macs += s_len * cfg.seq_item_feature_dim * d
    macs += len(cfg.non_seq_features) * cfg.feature_embed_dim * n * d
    cur = total
    for keep in pyramid_keep_lengths(cfg, total):
        macs += cur * d * d * 2  # K, V
        macs += keep * d * d  # Q (shared and dedicated cost the same)
        macs += keep * cur * d * 2  # QK^T and PV
        macs += keep * d * d  # O
        macs += keep * d * f * 2  # FFN
        cur = keep
    macs += len(cfg.tasks) * (d * cfg.task_head_hidden + cfg.task_head_hidden)
    flops = 2.0 * macs
    return flops * 3.0 if training else flops


def mfu(achieved_examples_per_s: float, flops_per_example: float,
        device_name: Optional[str] = None, n_chips: int = 1) -> float:
    """Model FLOPs utilization in percent of ``n_chips`` cards' dense bf16
    peak (``peak_flops``)."""
    peak = peak_flops(device_name) * n_chips
    return 100.0 * achieved_examples_per_s * flops_per_example / peak
