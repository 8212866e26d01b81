#!/usr/bin/env python3
"""Where a ranking request's time goes on the card, per chip_smoke phase.

    python3 profile_serving.py     # from the repository root; one CUDA card

For each of chip_smoke's serving phases (A, B, C: same configs, weights and
first request) it warms the engine, times ``score_request`` and
``batch_inference`` of 100 rows unprofiled (median of many calls on the host
clock), then traces a few calls of each with ``torch.profiler`` and prints,
per call: the unprofiled wall time, the profiled wall time, device busy time
(the sum of kernel times in the trace), the card's idle share against the
unprofiled wall time, the number of kernels launched, the band-attention
kernels' device time, and the kernels that took most device time. At
phase C's config, which is chip_smoke's phase S (the session cache), it
measures ``score_session`` with one new item per call the same way, each
call followed by ``maintain()``: the fold that the session queues (and,
after every fourth fold, the re-anchor) is timed and traced with the call
that made it due.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from recommend_tpu_torch.convert import init_params
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine

PHASES = (("A", 2, 64, 48), ("B", 2, 400, 400), ("C", 4, 64, 48))
# calls per measurement: (unprofiled, traced)
N_SCORE = (200, 10)
N_BATCH = (20, 2)


def device_kernels(prof):
    """(name, device microseconds) of every kernel the trace recorded."""
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((ev.name, ev.time_range.elapsed_us()))
    return out


def wall_p50(fn, n):
    """Median host-clock time of ``n`` unprofiled calls, in ms."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.percentile(times, 50))


def trace(fn, n):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    return wall_ms, device_kernels(prof)


def measure(label, what, fn, counts):
    n_wall, n = counts
    wall = wall_p50(fn, n_wall)
    traced_wall, kernels = trace(fn, n)
    busy = sum(us for _, us in kernels) / 1e3 / n
    by_name = defaultdict(float)
    for name, us in kernels:
        by_name[name] += us / 1e3 / n
    band = sum(ms for name, ms in by_name.items() if "band_attn" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} {what}: wall p50 {wall:.3f} ms (n={n_wall}), profiled wall "
          f"{traced_wall:.3f} ms, device busy {busy:.3f} ms (n={n}), idle "
          f"{1 - busy / wall:.1%}, {len(kernels) / n:.0f} kernels, "
          f"band_attn {band:.3f} ms")
    for name, ms in top:
        print(f"    {ms:8.4f} ms  {name[:110]}")


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    for label, heads, window, history in PHASES:
        cfg = chip_smoke.serving_config(heads)
        engine = RankingInferenceEngine(
            cfg, init_params(cfg, seed=chip_smoke.SEED, device="cuda"),
            max_seq_len=window, device="cuda")
        engine.warmup(chip_smoke.N_CANDIDATES)
        user, seqs, cands = chip_smoke.make_requests(
            cfg, np.random.default_rng(chip_smoke.SEED), 1, history)[0]
        rows = [(dict(user, **c), seqs) for c in cands]
        measure(label, "score_request",
                lambda: engine.score_request(user, seqs, cands), N_SCORE)
        measure(label, "batch_inference", lambda: engine.batch_inference(rows),
                N_BATCH)
        if label == "C":
            sf0 = cfg.sequence_features[0]
            engine.update_session("p", seqs)

            def session_call():
                engine.score_session("p", user, cands, new_items={sf0: [7]})
                engine.maintain()

            measure(label, "score_session (1 new item) + maintain", session_call,
                    N_SCORE)
        del engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
