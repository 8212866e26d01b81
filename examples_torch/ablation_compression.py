"""The adaptive-compression ablation on the PyTorch/CUDA port: the
counterpart of ``examples/ablation_compression.py``, with its flags,
configs, data and printed lines.

Reference (kuaiformer translation:126-155, 286-292, Table 3): compressing a
256-item history to 55 tokens costs ~+10% compute vs a 64-item sequence and
matches (slightly beats) the raw 256 sequence in accuracy, while the raw 256
sequence costs ~6x. This script checks the claim directionally on
structured synthetic data: it trains the retrieval tower with (a)
compression on and (b) raw (uncompressed) sequences, then compares held-out
metrics and step time. Each arm prints one JSON line, and a last line sums
them up.

Usage:
    python examples_torch/ablation_compression.py [--steps 2000] [--seq 64]
    python examples_torch/ablation_compression.py --steps 3 --seq 16 --num_users 100 --device cpu

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises. ``--output`` also writes every printed line to one
JSON file.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--num_users", type=int, default=4000)
    p.add_argument("--output", default=None, help="also write the printed lines to this JSON")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def configs(seq: int):
    """(compressed, raw): ``retrieval_base`` at 4 layers with sparse updates
    and dropout 0.1; compressed groups L/2 items by L/8 and L/4 by L/8 ahead
    of a raw tail of L/4 (22 tokens at L = 64), raw makes every item a token."""
    from recommend_tpu_torch.config import get_config

    common = dict(
        max_seq_len=seq, num_layers=4, warmup_steps=200, batch_size=256,
        video_vocab_size=10000, use_sparse_embedding_updates=True,
        dropout_rate=0.1,
    )
    comp = get_config(
        "retrieval_base",
        compression_schedule=((seq // 2, seq // 8), (seq // 4, seq // 8), (seq // 4, 1)),
        **common,
    )
    raw = get_config("retrieval_base", compression_schedule=((seq, 1),), **common)
    return comp, raw


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_arm(cfg, train, heldout, data, steps, label, device) -> dict:
    """One warm step, ``min(50, steps)`` timed steps, the rest untimed, then
    held-out retrieval metrics over the whole corpus; prints and returns the
    arm's line."""
    import torch

    from recommend_tpu_torch.data.pipeline import prefetch, retrieval_batches
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    tr = RetrievalTrainer(cfg, total_steps=steps, device=device)
    it = prefetch(retrieval_batches(train, cfg, cfg.batch_size, seed=0), 4)
    state = tr.init_state(seed=0)
    generator = torch.Generator().manual_seed(0)  # the dropout stream
    state, _ = tr._train_step(state, tr._put_batch(next(it)), generator)
    _sync(device)
    t0 = time.perf_counter()
    n_timed = min(50, steps)
    for _ in range(n_timed):
        state, _ = tr._train_step(state, tr._put_batch(next(it)), generator)
    _sync(device)
    ms_step = (time.perf_counter() - t0) / n_timed * 1000
    for _ in range(steps - n_timed - 1):
        state, _ = tr._train_step(state, tr._put_batch(next(it)), generator)
    ev = RetrievalEvaluator(cfg, state.params, device=device)
    metrics = ev.evaluate_retrieval(
        data,
        itertools.islice(retrieval_batches(heldout, cfg, cfg.batch_size, seed=77), 4),
        ks=(10, 50),
    )
    out = {"label": label, "tokens": cfg.num_compressed_tokens,
           "ms_per_step": round(ms_step, 2), **{k: round(v, 4) for k, v in metrics.items()}}
    print(json.dumps(out), flush=True)
    return out


def run(args: argparse.Namespace) -> dict:
    """Both arms on one data set; returns each arm's line and the summary line."""
    import torch

    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.data.synthetic import make_retrieval_data

    device = resolve_device(args.device, "ablation_compression")
    cfg_comp, cfg_raw = configs(args.seq)
    data = make_retrieval_data(cfg_comp, num_users=args.num_users,
                               num_videos=10000, seed=0, structured=True)
    cut = int(args.num_users * 0.9)
    train = dataclasses.replace(data, user_sequences=data.user_sequences[:cut])
    heldout = dataclasses.replace(data, user_sequences=data.user_sequences[cut:])

    comp = train_arm(cfg_comp, train, heldout, data, args.steps, "compressed", device)
    raw = train_arm(cfg_raw, train, heldout, data, args.steps, "raw", device)
    speedup = raw["ms_per_step"] / comp["ms_per_step"]
    summary = {
        "compression_token_reduction": f"{raw['tokens']}→{comp['tokens']}",
        "step_time_speedup": round(speedup, 2),
        "recall@50_delta": round(comp["recall@50"] - raw["recall@50"], 4),
    }
    print(json.dumps(summary), flush=True)
    if args.output:
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        with open(args.output, "w") as f:
            json.dump({"argv": vars(args), "device": card, "compressed": comp,
                       "raw": raw, "summary": summary}, f, indent=1, ensure_ascii=False)
    return dict(compressed=comp, raw=raw, summary=summary)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
