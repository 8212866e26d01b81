"""Flagship retrieval step-time benchmark on the PyTorch/CUDA port: the
counterpart of ``examples/flagship_bench.py``, the V=10M scoreboard row.

Measures ``retrieval_flagship``'s steady-state ``RetrievalTrainer`` step
(10M-video vocabulary, 256 items compressed to 55 tokens, 6 layers at d 128,
batch 256, bf16, rowwise sparse updates) and A/Bs the preset's
``sparse_scatter_budget`` (16,384 rows compacted on the host) against none.
The protocol is the JAX script's: one warm step on the first batch, then
``--steps`` timed steps cycling 10 batches placed on the device beforehand,
timed to the host read of the last loss. Random weights from seed 0.

``--num_users`` (the JAX script's fixed 2,000 by default) sizes the
synthetic data, which draws each user's history over the whole 10M-entry
popularity (~0.13 s a user on the host); it is made once for both arms.

Usage:
    python examples_torch/flagship_bench.py [--steps 60] [--output out.json]

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.training.trainer import RetrievalTrainer


def measure(cfg, steps: int, device=None, data=None) -> dict:
    """ms a step, examples/s and the last loss of ``steps`` timed steps
    (and the rows the scatter budget dropped, when it is set). ``data``:
    the ``make_retrieval_data`` to draw batches from (the JAX script's
    2,000 users over the whole vocabulary when None)."""
    device = resolve_device(device, "flagship_bench")
    if data is None:
        data = make_retrieval_data(cfg, num_users=2000, num_videos=cfg.video_vocab_size,
                                   seed=0)
    it = retrieval_batches(data, cfg, cfg.batch_size, seed=0)
    trainer = RetrievalTrainer(cfg, total_steps=steps + 20, device=device)
    first = next(it)
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    state, m = trainer._train_step(state, trainer._put_batch(first), gen)
    float(m["loss"])  # first step + sync
    batches = [trainer._put_batch(next(it)) for _ in range(10)]
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = trainer._train_step(state, batches[i % 10], gen)
    final_loss = float(m["loss"])  # the host read waits for every step
    dt = time.perf_counter() - t0
    out = {
        "ms_per_step": dt / steps * 1000,
        "examples_per_s": steps * cfg.batch_size / dt,
        "loss": final_loss,
    }
    if "sparse_dropped_rows" in m:
        out["sparse_dropped_rows"] = int(m["sparse_dropped_rows"])
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--output", default=None)
    ap.add_argument("--num_users", type=int, default=2000,
                    help="users of the synthetic data (the JAX script's 2000)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device, "flagship_bench")
    report = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else str(device))}
    data = None
    for tag, overrides in (
        ("flagship_budget_16384", {}),  # preset default: budget on
        ("flagship_budget_off", {"sparse_scatter_budget": 0}),
    ):
        cfg = get_config("retrieval_flagship", **overrides)
        if data is None:
            data = make_retrieval_data(cfg, num_users=args.num_users,
                                       num_videos=cfg.video_vocab_size, seed=0)
        print(f"[{time.strftime('%H:%M:%S')}] measuring {tag} "
              f"(V={cfg.video_vocab_size}, batch {cfg.batch_size})", flush=True)
        report[tag] = measure(cfg, args.steps, device=device, data=data)
        print(json.dumps({tag: report[tag]}), flush=True)

    a = report["flagship_budget_16384"]["ms_per_step"]
    b = report["flagship_budget_off"]["ms_per_step"]
    report["budget_speedup"] = b / a
    print(json.dumps(report, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
