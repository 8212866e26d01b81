"""Serving demos on the PyTorch/CUDA port: the counterpart of
``examples/serving_demo.py``. A batch-size sweep of KV-cached
``score_request``, a QPS loop over sessions (``update_session`` then
``score_session``), and the retrieval ``RealTimeRecommender`` session flow.
The models take random weights from seed 0 (``convert.init_params``,
``convert.init_retrieval_params``).

Usage:
    python examples_torch/serving_demo.py [--requests 50] [--candidates 100]
    python examples_torch/serving_demo.py --tiny --device cpu

``--tiny`` takes the JAX script's small widths for a CPU run. It runs on
the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX script's small widths (examples/serving_demo.py:45-49, 95-97)
TINY_RANKING = dict(
    embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, num_ns_tokens=4,
    pyramid_ratios=(0.5, 0.25), feature_embed_dim=8, seq_item_feature_dim=8,
    use_mixed_precision=False, task_head_hidden=16,
)
TINY_RETRIEVAL = dict(embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64,
                      max_seq_len=16, compression_schedule=((8, 4), (8, 1)),
                      compute_dtype="float32")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--candidates", type=int, default=100)
    p.add_argument("--seq_len", type=int, default=32)
    p.add_argument("--tiny", action="store_true", help="small model for CPU smoke runs")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the sweep's ms per request by candidate count, the loop's
    QPS, both engines' stats and the recommendations."""
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.convert import init_params, init_retrieval_params
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
    from recommend_tpu_torch.serving.retrieval_service import (
        RealTimeRecommender,
        RetrievalIndex,
    )

    device = resolve_device(args.device, "serving_demo")
    # ---- ranking: batch-size sweep + QPS loop ----
    cfg = get_config("ranking_small", dense_lr=1e-3, dense_momentum=0.9, sparse_lr=0.05,
                     **(TINY_RANKING if args.tiny else {}))
    engine = RankingInferenceEngine(cfg, init_params(cfg, seed=0, device=device),
                                    max_seq_len=args.seq_len, device=device)

    user_ctx = {f: 1 for f in cfg.user_features + cfg.context_features}
    seqs = {sf: list(range(1, 10)) for sf in cfg.sequence_features}
    # ids inside each feature's table: the JAX script's 1..n and 1..500
    # overrun ranking_small's 64 price buckets, where its lookup reads NaN
    # and the port's engine raises
    top = {f: cfg.vocab_size(f) - 1 for f in cfg.item_features}

    print("== batch-size sweep (KV-cached candidate scoring) ==")
    sweep = {}
    for n_cand in (1, 10, 50, args.candidates):
        cands = [{f: 1 + i % top[f] for f in cfg.item_features} for i in range(n_cand)]
        engine.score_request(user_ctx, seqs, cands)  # warm-up
        t0 = time.perf_counter()
        for _ in range(5):
            engine.score_request(user_ctx, seqs, cands)
        dt = (time.perf_counter() - t0) / 5 * 1000
        sweep[n_cand] = dt
        print(f"  {n_cand:4d} candidates: {dt:7.1f} ms/request "
              f"({n_cand / dt * 1000:8.0f} candidates/s)")

    print("== QPS-simulating service loop (sessionized) ==")
    rng = random.Random(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        sid = f"user_{rng.randint(0, 9)}"
        engine.update_session(sid, {"click_seq": [rng.randint(1, 500)]})
        cands = [{f: rng.randint(1, min(500, top[f])) for f in cfg.item_features}
                 for _ in range(16)]
        engine.score_session(sid, user_ctx, cands)
    wall = time.perf_counter() - t0
    qps = args.requests / wall
    print(f"  {args.requests} requests in {wall:.2f}s -> {qps:.1f} QPS")
    ranking_stats = engine.stats()
    print("  engine stats:", {k: round(v, 2) if isinstance(v, float) else v
                              for k, v in ranking_stats.items()})

    # ---- retrieval: real-time recommender ----
    rcfg = get_config("retrieval_small", top_k=50, **(TINY_RETRIEVAL if args.tiny else {}))
    rdata = make_retrieval_data(rcfg, num_users=20, num_videos=2000, seed=0)
    rparams = init_retrieval_params(rcfg, seed=0, device=device)
    index = RetrievalIndex(rcfg, rparams, embed_batch=1024, device=device)
    index.build(rdata.corpus_features())
    rec = RealTimeRecommender(rcfg, rparams, index, device=device)
    print("== retrieval session flow ==")
    for vid in (3, 17, 42):
        rec.add_interaction("demo-user", {
            "video_id": vid, "category": 1, "tag": 2, "duration": 30.0,
            "timestamp": int(time.time()),
        })
    recs = rec.get_recommendations("demo-user", top_k=5)
    print("  top-5:", recs)
    retrieval_stats = rec.stats()
    print("  stats:", retrieval_stats)
    return dict(sweep_ms=sweep, qps=qps, ranking_stats=ranking_stats, recs=recs,
                retrieval_stats=retrieval_stats, engine=engine)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
