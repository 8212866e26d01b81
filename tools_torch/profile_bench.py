"""Time or trace the bench-config ranking training step on the port: the
counterpart of ``tools/profile_bench.py``.

Runs bench.py's ranking config (OneTrans-S-like, ``--geometry S``) or the
OneTrans-L-like geometry (``--geometry L``: d 384, 8 layers, 3 heads of
128, FFN 1536, eight pyramid ratios), both with 12 NS tokens, bf16,
rowwise sparse updates and ``make_ranking_data(num_samples=4096,
max_seq_per_feature=--seq, seed=0)``, the JAX tool's config field for field.
The protocol is the JAX tool's: one step and a host fetch of its loss, 10
warm steps cycling 8 placed batches and a fetch, then the window:

- ``--no-trace``: ``--steps`` steps on the wall clock to a host fetch of the
  last loss; prints ms/step, ex/s and the wall-clock MFU
  (``ranking_model_flops`` × batch over the wall step time, against the
  card's dense bf16 peak, ``evaluation.benchmark.peak_flops``);
- otherwise ``torch.profiler`` over ``--steps`` steps (CPU and CUDA
  activity, stacks, shapes and flops; the recorder on, so that each step's
  spans mark it: ``train_step_<i>``, i the trainer's step count, over
  ``forward``, ``backward``, ``optimizer`` and ``sparse_update``), one
  Chrome trace written under ``--out``, and the host-observed ms/step.

Usage (one CUDA card):
    python tools_torch/profile_bench.py --geometry L --seq 396 --no-trace --steps 10
    python tools_torch/profile_bench.py --geometry L --seq 396 --out build/prof_L
    python tools_torch/analyze_profile.py build/prof_L --json build/prof_L.json
    python tools_torch/mfu_accounting.py build/prof_L.json --geometry L --seq 396

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data.pipeline import ranking_batches
from recommend_tpu_torch.data.synthetic import make_ranking_data
from recommend_tpu_torch.evaluation.benchmark import (device_memory_stats, peak_flops,
                                                      ranking_model_flops)
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from recommend_tpu_torch.utils import profiling

GEOMETRY = {
    "S": dict(embed_dim=256, num_layers=6, num_heads=2, ffn_dim=1024,
              pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03)),
    "L": dict(embed_dim=384, num_layers=8, num_heads=3, ffn_dim=1536,
              pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01)),
}
NUM_SAMPLES = 4096
WARM_STEPS = 10
PLACED_BATCHES = 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/prof_bench")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--geometry", choices=("S", "L"), default="S")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq", type=int, default=116,
                    help="max behavior-sequence length per feature")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--no-trace", action="store_true",
                    help="steady-state timing only (no profiler overhead)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def config(geometry: str, batch: int, flash: bool = True):
    """The JAX tool's config for ``geometry`` at batch ``batch``."""
    return get_config(
        "ranking_base", **GEOMETRY[geometry],
        num_ns_tokens=12,
        batch_size=batch, use_mixed_precision=True, use_remat=False,
        dropout_rate=0.0, feature_embed_dim=128, seq_item_feature_dim=128,
        use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
        use_flash_attention=flash,
        dense_lr=1e-3, dense_momentum=0.9, sparse_lr=0.05,
    )


def flops_per_step(cfg, first) -> float:
    """Analytic training flops of one step (forward × 3) at the S length of
    batch ``first`` (its sequences and the [SEP]s between them)."""
    names = [f for f in cfg.sequence_features if f in first["sequences"]]
    s_len = sum(first["sequences"][f].shape[1] for f in names) + max(len(names) - 1, 0)
    return ranking_model_flops(cfg, s_len, training=True) * cfg.batch_size


def run(args: argparse.Namespace) -> dict:
    """The timing (``--no-trace``) or the trace; returns what it printed,
    with the last loss, the flops, the card's peak and memory."""
    device = resolve_device(args.device, "profile_bench")
    cfg = config(args.geometry, args.batch, not args.no_flash)
    data = make_ranking_data(cfg, num_samples=NUM_SAMPLES, max_seq_per_feature=args.seq,
                             seed=0)
    it = ranking_batches(data, cfg, batch_size=cfg.batch_size, seed=0)
    trainer = RankingTrainer(cfg, device=device)
    first = next(it)
    state = trainer.init_state(seed=0)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    print("warming up...", flush=True)
    state, m = trainer._train_step(state, trainer._put_batch(first))
    float(m["loss"])  # a host fetch is the barrier
    batches = [trainer._put_batch(next(it)) for _ in range(PLACED_BATCHES)]
    for i in range(WARM_STEPS):
        state, m = trainer._train_step(state, batches[i % PLACED_BATCHES])
    float(m["loss"])

    flops = flops_per_step(cfg, first)
    name = torch.cuda.get_device_name(device) if cuda else str(device)
    peak = peak_flops(name) if cuda else None
    report = {"geometry": args.geometry, "batch": cfg.batch_size, "seq": args.seq,
              "steps": args.steps, "flops_per_step": flops, "device": name,
              "peak_flops": peak}
    t0 = time.perf_counter()
    if args.no_trace:
        for i in range(args.steps):
            state, m = trainer._train_step(state, batches[i % PLACED_BATCHES])
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        ms = dt / args.steps * 1e3
        mfu = flops / (ms / 1e3) / peak * 100.0 if peak else None
        report.update(ms_per_step=ms, examples_per_s=args.steps * cfg.batch_size / dt,
                      mfu_wall_pct=mfu, loss=loss, **device_memory_stats(device))
        mfu_text = (f"{mfu:.3f}% (wall-clock MFU: analytic fwd×3 over the wall step, "
                    f"{name} {peak / 1e12:.1f} TF/s bf16)" if mfu is not None
                    else "not computed (no bf16 peak for the CPU)")
        print(f"{args.steps} steps in {dt:.2f}s: {ms:.2f} ms/step, "
              f"{report['examples_per_s']:.0f} ex/s, train MFU {mfu_text}", flush=True)
        return report

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=True, record_shapes=True,
                                with_flops=True) as prof, profiling.recording():
        for i in range(args.steps):
            state, m = trainer._train_step(state, batches[i % PLACED_BATCHES])
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_{args.geometry}_{args.steps}.json")
    prof.export_chrome_trace(path)
    ms = dt / args.steps * 1e3
    report.update(ms_per_step_traced=ms, loss=loss, trace=path, **device_memory_stats(device))
    print(f"traced {args.steps} steps in {dt:.2f}s ({ms:.1f} ms/step host-observed, "
          f"{args.steps * cfg.batch_size / dt:.0f} ex/s) → {path}", flush=True)
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
