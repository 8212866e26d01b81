#!/usr/bin/env python3
"""The ML-1M replica retrieval quality run of the PyTorch/CUDA port.

    python3 quality_torch.py                        # full scale, on the card
    python3 quality_torch.py --scale small --device cpu

The port's counterpart of the ML-1M track of ``examples/quality_parity.py``:
the KuaiFormer tower at ``retrieval_base`` (video vocabulary 4000, 20
categories, 512 tags, dropout 0.1, top 100) trained by ``RetrievalTrainer``
for 8,000 steps of batch 256 (1,000 warm-up steps) on the full-scale
MovieLens-1M statistical replica (``data/replica.make_ml1m_replica``, 6,040
users), with each user's last event held out (``leave_one_out_split``);
batches from the native batcher through ``prefetch``. Then
``RetrievalEvaluator.evaluate_retrieval`` over the held-out events
(``leave_one_out_batches``, one per user, the whole 3,706-item corpus
searched) at k = 1, 5, 10, 50, 100, and the popularity baseline under the
same protocol. ``--scale small`` is the recipe's smoke size: 300 users, 120
steps of batch 64, a 2-layer d-64 tower.

The trainer saves a checkpoint every 500 steps into ``--checkpoint-dir``
(under ``build/`` by default); a run started again with the same arguments
resumes from the newest one and skips the batches already trained on, so a
run cut short carries on where it stopped and ends as an unbroken run would
(the retrieval trainer's resume is bit-equal). It writes the metrics, the
train seconds and steps/s of this invocation, and the device (with the
card's name and power limit from ``nvidia-smi``) to ``--output`` as JSON.
It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

KS = (1, 5, 10, 50, 100)
CHECKPOINT_EVERY = 500
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def recipe(scale: str) -> dict:
    full = scale == "full"
    steps = 8000 if full else 120
    return dict(
        num_users=6040 if full else 300,
        steps=steps,
        batch=256 if full else 64,
        cfg=dict(
            video_vocab_size=4000, category_vocab_size=20, tag_vocab_size=512,
            batch_size=256 if full else 64, warmup_steps=min(1000, steps // 4),
            dropout_rate=0.1, top_k=100,
            **({} if full else dict(embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
                                    max_seq_len=64,
                                    compression_schedule=((32, 16), (32, 1))))),
    )


def popularity_baseline(data, test) -> dict:
    """recall@k of ranking every user's held-out item by corpus popularity."""
    order = np.argsort(-data.popularity)
    pop_rank = np.empty(len(order), dtype=np.int64)
    pop_rank[order] = np.arange(len(order))
    targets = np.array([s["video_id"][-1] for s in test.user_sequences
                        if len(s["video_id"]) >= 2])
    return {f"recall@{k}": float((pop_rank[targets] < k).mean()) for k in KS}


def run(scale: str, seed: int, device, checkpoint_dir: Path) -> dict:
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.datasets import leave_one_out_split
    from recommend_tpu_torch.data.pipeline import prefetch, retrieval_batches
    from recommend_tpu_torch.data.replica import leave_one_out_batches, make_ml1m_replica
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    r = recipe(scale)
    cfg = get_config("retrieval_base", **r["cfg"])
    t0 = time.perf_counter()
    data = make_ml1m_replica(cfg, num_users=r["num_users"], seed=seed)
    n_events = sum(len(s["video_id"]) for s in data.user_sequences)
    train, test = leave_one_out_split(data)
    data_s = time.perf_counter() - t0
    log(f"ml1m replica: {r['num_users']} users, {n_events} events, {data.num_videos} items "
        f"({data_s:.1f} s)")

    # one checkpoint kept (37.8 MB at full scale): small enough to carry
    # from one chip call to the next
    trainer = RetrievalTrainer(cfg, total_steps=r["steps"], checkpoint_dir=str(checkpoint_dir),
                               max_to_keep=1, device=device)
    start = trainer.ckpt.latest_step() or 0
    # the batches already trained on are skipped, so a resumed run sees the
    # stream an unbroken one does
    batches = itertools.islice(
        retrieval_batches(train, cfg, r["batch"], seed=seed, use_native=True), start, None)
    log(f"training steps {start}-{r['steps']} (checkpoints every {CHECKPOINT_EVERY} steps in "
        f"{checkpoint_dir})")
    t0 = time.perf_counter()
    state = trainer.train(prefetch(batches, size=4), num_steps=r["steps"],
                          eval_every=CHECKPOINT_EVERY, log_every=max(r["steps"] // 10, 1),
                          seed=seed)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    for h in trainer.history["train"]:
        log(f"step {h['step']}: loss {h['loss']:.4f}, {h['steps_per_s']:.2f} steps/s")

    evaluator = RetrievalEvaluator(cfg, state.params, device=trainer.device)
    t0 = time.perf_counter()
    metrics = evaluator.evaluate_retrieval(test, leave_one_out_batches(test, cfg, r["batch"]),
                                           ks=KS)
    eval_s = time.perf_counter() - t0
    return {
        "config": f"KuaiFormer retrieval_base {cfg.num_layers}L d={cfg.embed_dim} "
                  f"seq{cfg.max_seq_len}->{cfg.num_compressed_tokens} on the ML-1M replica "
                  f"({r['num_users']} users, {n_events} events, leave-one-out)",
        "scale": scale,
        "seed": seed,
        "train_steps": r["steps"],
        "start_step": start,
        "train_seconds": train_s,
        "steps_per_s": (r["steps"] - start) / train_s,
        "data_seconds": data_s,
        "eval_seconds": eval_s,
        "metrics": metrics,
        "popularity_baseline": popularity_baseline(data, test),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=("full", "small"), default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu for a rehearsal)")
    ap.add_argument("--checkpoint-dir", type=Path, default=None,
                    help="default: build/quality_torch/ml1m_<scale>_seed<seed>")
    ap.add_argument("--output", type=Path, default=ROOT / "quality_torch_ml1m.json")
    args = ap.parse_args(argv)
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("quality_torch: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    device = torch.device(args.device or "cuda")
    ckpt = args.checkpoint_dir or (ROOT / "build" / "quality_torch"
                                   / f"ml1m_{args.scale}_seed{args.seed}")
    on_card = device.type == "cuda"
    if on_card:
        from chip_smoke import card_line  # nvidia-smi's name and power limit
    where = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
             "card": card_line() if on_card else "not measured (CPU run)"}
    log(f"{where['device']} | {where['card']}")
    result = {**where, "ml1m_replica": run(args.scale, args.seed, device, ckpt)}
    m, pop = result["ml1m_replica"]["metrics"], result["ml1m_replica"]["popularity_baseline"]
    log(f"recall@10 {m['recall@10']:.4f} (popularity {pop['recall@10']:.4f}), recall@100 "
        f"{m['recall@100']:.4f} (popularity {pop['recall@100']:.4f}), ndcg@10 "
        f"{m['ndcg@10']:.4f}, mrr {m['mrr']:.4f}")
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(result, indent=2) + "\n")
    log(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
