"""End-to-end retrieval training on the PyTorch/CUDA port, and its quick
start.

The port's counterpart of ``examples/train_retrieval.py``, with its flags
and outputs: config (``<model_dir>/config.json``) -> synthetic data or
MovieLens-1M -> ``RetrievalTrainer`` (checkpoints in ``<model_dir>/ckpt``,
logs in ``<model_dir>/logs``) -> full-corpus retrieval metrics
(``<model_dir>/eval.json``) -> latency.

Usage:
    python examples_torch/train_retrieval.py --config retrieval_small --steps 500
    python examples_torch/train_retrieval.py --quick-start
    python examples_torch/train_retrieval.py --quick-start --device cpu

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="retrieval_small")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_users", type=int, default=1000)
    p.add_argument("--num_videos", type=int, default=10000)
    p.add_argument("--model_dir", default="/tmp/recommend_tpu/retrieval")
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--quick-start", action="store_true")
    p.add_argument("--causal", action="store_true", help="causal single-sequence mode")
    p.add_argument("--movielens", default=None, metavar="DIR",
                   help="train on MovieLens-1M (directory with ratings.dat/movies.dat) "
                        "instead of synthetic data; evaluation uses the BERT4Rec "
                        "leave-one-out split")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train, evaluate and time; returns the config, the trainer, its final
    state, the metrics and the latency."""
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.config import get_config, save_config
    from recommend_tpu_torch.data.pipeline import prefetch, retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    device = resolve_device(args.device, "train_retrieval")
    if args.quick_start:
        args.steps, args.num_users, args.num_videos = 100, 100, 1000

    cfg = get_config(args.config, batch_size=args.batch_size, use_causal_mask=args.causal)
    os.makedirs(args.model_dir, exist_ok=True)
    save_config(cfg, os.path.join(args.model_dir, "config.json"))

    if args.movielens:
        from recommend_tpu_torch.data.datasets import leave_one_out_split, load_movielens_1m

        full = load_movielens_1m(args.movielens, cfg)
        data, val_data = leave_one_out_split(full)
        print(f"MovieLens-1M: {len(data.user_sequences)} users, {data.num_videos} items")
    else:
        data = make_retrieval_data(cfg, args.num_users, args.num_videos, seed=0)
        val_data = data
    train_iter = prefetch(retrieval_batches(data, cfg, args.batch_size, seed=0), size=4)

    def val_fn():
        return itertools.islice(retrieval_batches(val_data, cfg, args.batch_size, seed=99), 4)

    trainer = RetrievalTrainer(
        cfg,
        total_steps=args.steps,
        checkpoint_dir=os.path.join(args.model_dir, "ckpt"),
        log_dir=os.path.join(args.model_dir, "logs"),
        device=device,
    )
    state = trainer.train(
        train_iter, args.steps, val_fn=val_fn,
        eval_every=args.eval_every, log_every=max(args.steps // 10, 1),
    )

    evaluator = RetrievalEvaluator(cfg, state.params, device=device)
    metrics = evaluator.evaluate_retrieval(
        data,
        itertools.islice(retrieval_batches(data, cfg, args.batch_size, seed=7), 8),
        ks=(1, 5, 10, 50, 100),
    )
    print("full-corpus retrieval metrics:", json.dumps(metrics, indent=2))
    evaluator.save_results(metrics, os.path.join(args.model_dir, "eval.json"))

    batch = next(iter(retrieval_batches(data, cfg, args.batch_size, num_epochs=1)))
    latency = evaluator.benchmark_latency(batch, n_iters=20)
    print("latency:", latency)
    return dict(cfg=cfg, data=data, trainer=trainer, state=state, metrics=metrics,
                latency=latency)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
