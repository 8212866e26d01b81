"""Data-parallel scaling on the PyTorch/CUDA port: the counterpart of
``examples/scaling_bench.py``. Examples/s and examples/s a rank at 1..N
ranks of a ('data', 'model') = (n, 1) mesh, and the scaling efficiency
against the smallest world.

The configs and the protocol are the JAX script's: ``ranking_base`` at 6
layers, d 256, 4 heads, 12 NS tokens, rowwise sparse updates, 116 items a
sequence, ``use_flash_attention`` left off as the JAX script runs it (the
plain attention path, no band-attention kernel); or ``retrieval_base``
with sparse updates; ``--tiny`` the JAX script's small widths. Each world takes one step on the first batch, then ``--steps``
timed steps cycling up to 10 batches placed beforehand, timed to the host
read of the last loss; the global batch is ``--per_chip_batch`` a rank.
Random weights from seed 0.

Each world size runs on its own process group (``parallel.launch``): one
rank a card over NCCL, at every card there is; ``--virtual N`` (the JAX
flag for N virtual CPU devices) runs gloo ranks on the CPU instead, which
checks the mechanics and measures nothing of a card. It runs on the card
unless given ``--device cpu`` or ``--virtual``; without CUDA and without
either it raises.

Usage:
    python examples_torch/scaling_bench.py [--model ranking|retrieval] [--steps 30]
    python examples_torch/scaling_bench.py --virtual 8 --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data.pipeline import ranking_batches, retrieval_batches
from recommend_tpu_torch.data.synthetic import make_ranking_data, make_retrieval_data
from recommend_tpu_torch.parallel import make_mesh
from recommend_tpu_torch.parallel.launch import launch
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from recommend_tpu_torch.training.trainer import RetrievalTrainer

# the JAX script's widths (examples/scaling_bench.py:71-83, 95-101)
RANKING_TINY = dict(
    embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128, num_ns_tokens=4,
    pyramid_ratios=(0.5, 0.25), feature_embed_dim=16, seq_item_feature_dim=16,
    use_mixed_precision=False,
)
RANKING_FULL = dict(
    embed_dim=256, num_layers=6, num_heads=4, ffn_dim=1024, num_ns_tokens=12,
    pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03), feature_embed_dim=128,
    seq_item_feature_dim=128, use_sparse_embedding_updates=True,
)
RETRIEVAL_TINY = dict(
    embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, max_seq_len=16,
    compression_schedule=((8, 4), (8, 1)), video_vocab_size=1000, compute_dtype="float32",
)
RETRIEVAL_FULL = dict(use_sparse_embedding_updates=True)


def measure(trainer, it, steps: int, global_batch: int) -> float:
    """Examples/s of ``steps`` timed steps (global batch over the wall)."""
    gen = torch.Generator().manual_seed(0)
    state = trainer.init_state(seed=0)
    state, m = trainer._train_step(state, trainer._put_batch(next(it)), gen)
    float(m["loss"])  # sync
    batches = [trainer._put_batch(next(it)) for _ in range(min(steps, 10))]
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = trainer._train_step(state, batches[i % len(batches)], gen)
    float(m["loss"])  # sync
    return steps * global_batch / (time.perf_counter() - t0)


def _world_rank(model: str, steps: int, per_chip_batch: int, tiny: bool, device: str) -> float:
    """One rank of a world of n: the mesh (n, 1), the config at the global
    batch, the same data on every rank (each keeps its block of a batch)."""
    n = dist.get_world_size()
    mesh = make_mesh(data=n, model=1, device=device)
    global_batch = per_chip_batch * n
    if model == "ranking":
        cfg = get_config("ranking_base", batch_size=global_batch, dropout_rate=0.0,
                         dense_lr=1e-3, dense_momentum=0.9, sparse_lr=0.05,
                         **(RANKING_TINY if tiny else RANKING_FULL))
        data = make_ranking_data(cfg, max(2048, global_batch * 4), 16 if tiny else 116, seed=0)
        trainer = RankingTrainer(cfg, mesh=mesh)
        it = ranking_batches(data, cfg, global_batch, seed=0)
    else:
        cfg = get_config("retrieval_small" if tiny else "retrieval_base",
                         batch_size=global_batch, dropout_rate=0.0,
                         **(RETRIEVAL_TINY if tiny else RETRIEVAL_FULL))
        data = make_retrieval_data(cfg, 500 if tiny else 5000, 1000 if tiny else 100000, seed=0)
        trainer = RetrievalTrainer(cfg, total_steps=steps + 10, mesh=mesh)
        it = retrieval_batches(data, cfg, global_batch, seed=0)
    return measure(trainer, it, steps, global_batch)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ranking", choices=["ranking", "retrieval"])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--per_chip_batch", type=int, default=128)
    p.add_argument("--virtual", type=int, default=0,
                   help="N gloo ranks on the CPU (mechanics test)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device("cpu" if args.virtual else args.device, "scaling_bench")
    if args.virtual:
        n_dev = args.virtual
    else:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    pow2 = {1 << i for i in range(5)}  # 1, 2, 4, 8, 16
    sizes = sorted(({1, 2, n_dev} | pow2) & set(range(1, n_dev + 1)))

    results = {}
    for n in sizes:
        ex_s = launch(n, _world_rank, args.model, args.steps, args.per_chip_batch, args.tiny,
                      device.type, device=device)
        per_chip = ex_s / n
        results[n] = {"examples_per_s": ex_s, "examples_per_s_per_chip": per_chip}
        base = results[sizes[0]]["examples_per_s_per_chip"]
        results[n]["scaling_efficiency"] = per_chip / base
        print(f"{n} chip(s): {ex_s:10.0f} ex/s total, {per_chip:10.0f} /chip, "
              f"efficiency {results[n]['scaling_efficiency']:.1%}", flush=True)
    report = {"model": args.model, "results": results}
    print(json.dumps(report))
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
