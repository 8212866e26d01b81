"""Evaluation CLI of the PyTorch/CUDA port: the counterpart of
``examples/evaluate.py``, on the port's own checkpoints
(``training/checkpoint.py``: ``ckpt_<step>.pt`` beside ``config.json``).

    python examples_torch/evaluate.py retrieval --checkpoint DIR [--output DIR]
    python examples_torch/evaluate.py ranking --checkpoint DIR \
        [--eval_type offline|ab_test|importance|benchmark|all] [--output DIR]

``DIR`` is a trainer's ``checkpoint_dir`` (``<model_dir>/ckpt`` of
``train_retrieval.py`` and ``train_ranking.py``); a directory without a
checkpoint raises. ``benchmark`` (listed in the JAX script's usage, not in
its choices) times ``score_request`` of one 100-candidate request with
``latency_benchmark``; ``all`` runs every type. With ``--output`` it writes
``retrieval_eval.json`` or ``ranking_eval.json`` there, and the ranking
charts under ``charts/`` (none without matplotlib). It runs on the card
unless given ``--device cpu``; without CUDA and without ``--device`` it
raises.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EVAL_TYPES = ("offline", "ab_test", "importance", "benchmark", "all")


def _load_retrieval(ckpt_dir: str, device):
    from recommend_tpu_torch.config import load_config
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.training.checkpoint import wait_for_writes
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    wait_for_writes(ckpt_dir)
    cfg = load_config(os.path.join(ckpt_dir, "config.json"))
    trainer = RetrievalTrainer(cfg, checkpoint_dir=ckpt_dir, device=device)
    if trainer.ckpt.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    data = make_retrieval_data(cfg, num_users=500, num_videos=min(10000, cfg.video_vocab_size),
                               seed=0)
    state = trainer.init_state()
    return cfg, trainer, state, data


def eval_retrieval(args) -> dict:
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator

    device = resolve_device(args.device, "evaluate")
    cfg, trainer, state, data = _load_retrieval(args.checkpoint, device)
    ev = RetrievalEvaluator(cfg, state.params, device=device)
    out = {}
    out["retrieval"] = ev.evaluate_retrieval(
        data, itertools.islice(retrieval_batches(data, cfg, cfg.batch_size, seed=7),
                               args.batches))
    out["classification"] = ev.evaluate_classification(
        data, itertools.islice(retrieval_batches(data, cfg, cfg.batch_size, seed=8),
                               args.batches))
    batch = next(iter(retrieval_batches(data, cfg, cfg.batch_size, num_epochs=1)))
    out["latency"] = ev.benchmark_latency(batch, n_iters=20)
    print(json.dumps(out, indent=2, default=float))
    if args.output:
        ev.save_results(out, os.path.join(args.output, "retrieval_eval.json"))
    return out


def ranking_eval_data(cfg, batches: int):
    """The synthetic stream the ranking evaluation draws its batches from."""
    from recommend_tpu_torch.data.synthetic import make_ranking_data

    return make_ranking_data(cfg, num_samples=batches * cfg.batch_size * 2,
                             max_seq_per_feature=64, seed=0)


def ranking_eval_batches(data, cfg, batches: int, seed: int):
    """``batches`` batches of ``cfg.batch_size`` (offline: seed 7; A/B: 8
    and 9; importance: 10)."""
    from recommend_tpu_torch.data.pipeline import ranking_batches

    return itertools.islice(ranking_batches(data, cfg, cfg.batch_size, seed=seed), batches)


def eval_ranking(args) -> dict:
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.evaluation.benchmark import latency_benchmark
    from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine

    device = resolve_device(args.device, "evaluate")
    engine = RankingInferenceEngine.from_checkpoint(args.checkpoint, device=device)
    cfg = engine.cfg
    ev = RankingEvaluator(cfg, engine.model, engine.state_dict(), device=engine.device)
    data = ranking_eval_data(cfg, args.batches)
    out = {}
    if args.eval_type in ("offline", "all"):
        out["offline"] = ev.evaluate(ranking_eval_batches(data, cfg, args.batches, seed=7))
    if args.eval_type in ("ab_test", "all"):
        out["ab_test"] = ev.ab_test(ranking_eval_batches(data, cfg, args.batches, seed=8),
                                    ranking_eval_batches(data, cfg, args.batches, seed=9))
    if args.eval_type in ("importance", "all"):
        batches = list(ranking_eval_batches(data, cfg, min(args.batches, 2), seed=10))
        out["feature_importance"] = ev.feature_importance(batches)
    if args.eval_type in ("benchmark", "all"):
        # one request: row 0's user, context and history, 100 candidates'
        # item features from the stream
        row = 0
        user = {f: int(data.non_seq[f][row]) for f in cfg.user_features + cfg.context_features}
        seqs = {sf: data.sequences[sf][row][data.sequences[sf].shape[1]
                                            - data.seq_lengths[sf][row]:].tolist()
                for sf in cfg.sequence_features}
        n = min(100, data.num_samples)
        cands = [{f: int(data.non_seq[f][i]) for f in cfg.item_features} for i in range(n)]
        out["benchmark"] = {"candidates": n, **latency_benchmark(
            lambda: engine.score_request(user, seqs, cands), n_iters=20, batch_size=n,
            device=engine.device)}
    print(json.dumps(out, indent=2, default=float))
    if args.output:
        ev.save_report(out, os.path.join(args.output, "ranking_eval.json"))
        charts = ev.save_charts(
            out.get("offline", {}) | {"feature_importance": out.get("feature_importance")},
            os.path.join(args.output, "charts"))
        print("charts:", charts)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("retrieval")
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--output", default=None)
    pr.add_argument("--batches", type=int, default=4)
    pk = sub.add_parser("ranking")
    pk.add_argument("--checkpoint", required=True)
    pk.add_argument("--output", default=None)
    pk.add_argument("--batches", type=int, default=4)
    pk.add_argument("--eval_type", default="all", choices=EVAL_TYPES)
    for sp in (pr, pk):
        sp.add_argument("--device", default=None,
                        help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    return eval_retrieval(args) if args.cmd == "retrieval" else eval_ranking(args)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
