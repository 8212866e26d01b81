"""End-to-end ranking training on the PyTorch/CUDA port.

The port's counterpart of ``examples/train_ranking.py``, with its flags and
outputs: config -> data -> ``RankingTrainer`` (dense and touched-row sparse
optimizers, early stopping, checkpoints in ``<model_dir>/ckpt``, logs in
``<model_dir>/logs``) -> optional incremental parameter push -> offline
evaluation (``<model_dir>/eval.json``) -> KV-cached inference demo.

Usage:
    python examples_torch/train_ranking.py --config ranking_small --steps 500
    python examples_torch/train_ranking.py --steps 20 --batch_size 32 --device cpu

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
    p.add_argument("--config", default="ranking_small")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_samples", type=int, default=20000)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--model_dir", default="/tmp/recommend_tpu/ranking")
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--flash", action="store_true",
                   help="attention through the band-attention kernels")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--taobao", default=None, metavar="CSV",
                   help="train on Taobao UserBehavior.csv instead of synthetic data "
                        "(pv->click/cart+fav->cart/buy->purchase sequences, CTR=pv, "
                        "CVR=later-buy)")
    p.add_argument("--criteo", default=None, metavar="TSV",
                   help="train on the Criteo Kaggle train.txt (NS-only CTR; --config is "
                        "ignored, criteo_ranking_config is used)")
    p.add_argument("--push-dir", default=None, metavar="DIR",
                   help="track touched embedding rows during training and write an "
                        "incremental parameter push (serving.param_push) that a serving "
                        "engine applies with apply_push")
    p.add_argument("--tame-optimizer", action="store_true",
                   help="small-scale-friendly lrs instead of the paper's")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def eval_batches(data, cfg, batch_size: int):
    """The 8 offline-evaluation batches (seed 7)."""
    from recommend_tpu_torch.data.pipeline import ranking_batches

    return itertools.islice(ranking_batches(data, cfg, batch_size, seed=7), 8)


def run(args: argparse.Namespace) -> dict:
    """Train, push, evaluate and serve; returns the config, the data, the
    trainer, its final state, the offline metrics, the push's path (or
    None) and the engine."""
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.pipeline import prefetch, ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    device = resolve_device(args.device, "train_ranking")
    overrides = dict(
        batch_size=args.batch_size,
        use_flash_attention=args.flash,
        use_remat=args.remat,
    )
    if args.tame_optimizer:
        overrides.update(dense_lr=1e-3, dense_momentum=0.9, sparse_lr=0.05)
    if args.criteo:
        from recommend_tpu_torch.data.datasets import criteo_ranking_config

        cfg = criteo_ranking_config(**overrides)
    else:
        cfg = get_config(args.config, **overrides)

    if args.criteo:
        from recommend_tpu_torch.data.datasets import load_criteo_kaggle

        data = load_criteo_kaggle(args.criteo, max_samples=args.num_samples)
        print(f"Criteo: {data.num_samples} samples (NS-only)")
    elif args.taobao:
        from recommend_tpu_torch.data.datasets import load_taobao_userbehavior

        data = load_taobao_userbehavior(args.taobao, cfg, max_seq_per_feature=args.seq_len)
        print(f"Taobao UserBehavior: {data.num_samples} samples")
    else:
        data = make_ranking_data(cfg, args.num_samples, args.seq_len, seed=0)
    train_iter = prefetch(ranking_batches(data, cfg, args.batch_size, seed=0), 4)

    def val_fn():
        return itertools.islice(ranking_batches(data, cfg, args.batch_size, seed=99), 4)

    trainer = RankingTrainer(
        cfg,
        checkpoint_dir=os.path.join(args.model_dir, "ckpt"),
        log_dir=os.path.join(args.model_dir, "logs"),
        device=device,
    )
    tracker = None
    if args.push_dir:
        from recommend_tpu_torch.serving.param_push import PushTracker

        tracker = PushTracker(cfg)
        train_iter = tracker.wrap(train_iter)
    state = trainer.train(
        train_iter, args.steps, val_fn=val_fn, eval_every=args.eval_every,
        log_every=max(args.steps // 10, 1), early_stop_patience=args.patience,
    )
    push_path = None
    if tracker is not None:
        from recommend_tpu_torch.serving.param_push import build_push, save_push

        os.makedirs(args.push_dir, exist_ok=True)
        push = build_push(state.params, tracker.snapshot(), step=int(state.step))
        push_path = os.path.join(args.push_dir, f"push_{int(state.step):08d}.npz")
        nbytes = save_push(push, push_path)
        print(f"incremental param push: {push_path} ({nbytes / 2**20:.2f} MB; "
              f"apply with RankingInferenceEngine.apply_push)")

    evaluator = RankingEvaluator(cfg, trainer.model, state.params, device=device)
    metrics = evaluator.evaluate(eval_batches(data, cfg, args.batch_size))
    print("offline eval:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                       for k, v in metrics.items()}, indent=2))
    evaluator.save_report(metrics, os.path.join(args.model_dir, "eval.json"))

    # KV-cached serving demo (cross-candidate cache)
    engine = RankingInferenceEngine(cfg, state.params, max_seq_len=args.seq_len, device=device)
    user_ctx = {f: 1 for f in cfg.user_features + cfg.context_features}
    candidates = [{f: i + 1 for f in cfg.item_features} for i in range(10)]
    seqs = {sf: [1, 2, 3] for sf in cfg.sequence_features}
    scored = engine.score_request(user_ctx, seqs, candidates)
    print("KV-cached scores for 10 candidates:", scored[:3], "...")
    print("engine stats:", engine.stats())
    return dict(cfg=cfg, data=data, trainer=trainer, state=state, metrics=metrics,
                push_path=push_path, engine=engine, scored=scored)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
