"""Minute-level online learning, end to end, on the PyTorch/CUDA port: the
counterpart of ``examples/online_learning_demo.py``. One cycle of the loop:

  1. train the retrieval tower, checkpointing as it goes
  2. build the serving index (int8) and answer a query
  3. new items arrive -> ``RetrievalIndex.update_items`` (appended in place)
  4. train on from the checkpoint -> ``RetrievalIndex.refresh(new_params)``
     (a full parameter push; re-embeds the live corpus, new items included),
     and answer the query again

Run: python examples_torch/online_learning_demo.py [--steps 120] [--device cpu]

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--videos", type=int, default=5000)
    p.add_argument("--model_dir", default="/tmp/recommend_tpu/online_demo")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the index, the trainer's final state, the probe's top ids
    before and after the push, and how many ids moved."""
    from recommend_tpu_torch._device import resolve_device
    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    device = resolve_device(args.device, "online_learning_demo")
    # a fresh directory per run: a stale checkpoint would restore past
    # num_steps (skipping training) or fail on a shape mismatch
    shutil.rmtree(args.model_dir, ignore_errors=True)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:6.1f}s] {msg}", flush=True)

    cfg = get_config(
        "retrieval_small",
        video_vocab_size=args.videos + 64,  # headroom for new uploads
        batch_size=64,
        warmup_steps=20,
        use_sparse_embedding_updates=True,
        sparse_update_mode="rowwise",
        top_k=20,
    )
    data = make_retrieval_data(cfg, num_users=400, num_videos=args.videos, seed=0,
                               structured=True)

    # 1. initial training run with checkpoints
    trainer = RetrievalTrainer(cfg, total_steps=args.steps * 2, checkpoint_dir=args.model_dir,
                               device=device)
    state = trainer.train(
        retrieval_batches(data, cfg, batch_size=64, seed=0),
        num_steps=args.steps,
        log_every=max(args.steps // 2, 1),
    )
    first_step = int(state.step)
    log(f"initial training done (step {first_step})")

    # 2. serving index (int8 + approximate top-k) + a query
    index = RetrievalIndex(cfg, state.params, quantize="int8", approx_recall=0.99,
                           device=device)
    index.build(data.corpus_features())
    rng = np.random.default_rng(0)
    interests = rng.normal(size=(1, cfg.num_query_tokens, cfg.embed_dim)).astype(np.float32)
    _, ids_before = index.search(interests)
    log(f"index built ({args.videos} items); top-5 for probe: {ids_before[0][:5]}")

    # 3. new items arrive: incremental index update, no downtime
    corpus = data.corpus_features()
    fresh = {k: np.array(v[:8]) for k, v in corpus.items()}
    fresh["video_id"] = np.arange(args.videos, args.videos + 8, dtype=corpus["video_id"].dtype)
    index.update_items(fresh)
    log(f"8 new items appended in place (corpus now {index.item_embeddings.shape[0]})")

    # 4. continue training on fresh data (from the checkpoint), then push
    state = trainer.train(
        retrieval_batches(data, cfg, batch_size=64, seed=1),
        num_steps=args.steps * 2,
        log_every=args.steps,
    )
    index.refresh(state.params)
    _, ids_after = index.search(interests)
    changed = len(set(ids_before[0].tolist()) ^ set(ids_after[0].tolist()))
    kept = index.item_embeddings.shape[0] == args.videos + 8
    log(f"parameter push applied (step {int(state.step)}); results moved by {changed} ids "
        f"- new items remain indexed: {kept}")
    log("online learning cycle complete")
    return dict(cfg=cfg, data=data, trainer=trainer, state=state, index=index,
                first_step=first_step, ids_before=ids_before, ids_after=ids_after,
                changed=changed, new_items_indexed=kept)


def main(argv=None) -> int:
    """The command line; callers in the same process use ``run(parse_args(argv))``,
    which returns what the run made."""
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
