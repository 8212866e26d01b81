"""Sharded embedding-lookup protocols on the PyTorch/CUDA port: the
counterpart of ``examples/lookup_bench.py``.

Forward and forward+backward lookups on a [V, D] table sharded over the
``model`` axis of a (1, n) mesh, per protocol, with the analytic per-rank
traffic of each:

  protocol   forward bytes a rank          notes
  gspmd      the trainers' default path:   in the port the trainers look a
             sharded_lookup (psum)         row-sharded table up through
                                           sharded_lookup, so it times the
                                           psum function
  psum       B·D·4 (one all-reduce)        every rank gathers its rows,
                                           zeros for the others, all-reduce
  a2a        2·min(uniq, B)·D·4 / n        dedup first: O(unique), not O(B)
  column     B·D·4 (all_to_all)            D split; independent of the ids

The ids are the JAX script's: Zipf(1.1) ranks from numpy seed 0, hashed
over the id space; the table is drawn from the same generator.

``--devices N --device cpu`` runs N gloo ranks on the CPU (the JAX script's
own mode, a CPU mesh; timings there are directional: the collectives are
memory copies). On the card it runs one rank a card over NCCL, at every
card by default; ``--devices`` above the cards raises. At one card every
collective is a local copy. It runs on the card unless given
``--device cpu``; without CUDA and without ``--device`` it raises.

Usage:
    python examples_torch/lookup_bench.py --devices 8 --device cpu
    python examples_torch/lookup_bench.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.parallel import (
    make_mesh,
    shard_table,
    shard_table_column,
    sharded_lookup,
    sharded_lookup_a2a,
    sharded_lookup_column,
)
from recommend_tpu_torch.parallel.launch import launch
from recommend_tpu_torch.parallel.sharding import block


def _ids_and_table(vocab: int, dim: int, batch: int, zipf: float):
    """The JAX script's Zipf ids (spread over the id space as a hashed id
    space would) and normal table, from numpy seed 0."""
    rng = np.random.default_rng(0)
    ranks = rng.zipf(zipf, size=4 * batch)
    ids = (ranks[ranks <= vocab] - 1)[:batch].astype(np.int32)
    ids = (ids.astype(np.int64) * 2654435761 % vocab).astype(np.int32)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    return ids, table


def _bench_rank(vocab: int, dim: int, batch: int, zipf: float, iters: int, device) -> dict:
    """One rank's part: every protocol forward and backward, timed on this
    rank after a barrier (the median of ``iters`` calls); returns the
    report (rank 0's is the one kept)."""
    mesh = make_mesh(data=1, model=dist.get_world_size(), device=device)
    dev = mesh.device
    n, r = mesh.shape["model"], mesh.rank("model")
    ids_np, table_np = _ids_and_table(vocab, dim, batch, zipf)
    uniq = len(np.unique(ids_np))
    table = torch.as_tensor(table_np, device=dev)
    t_row = shard_table(mesh, table)
    t_col = shard_table_column(mesh, table)
    del table
    ids_rep = torch.as_tensor(ids_np, dtype=torch.int64, device=dev)
    ids_sh = torch.as_tensor(block(ids_np, n, r), dtype=torch.int64, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(f, *a):
        f(*a)
        sync()
        ts = []
        for _ in range(iters):
            mesh.barrier()
            t0 = time.perf_counter()
            f(*a)
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts) * 1000)

    def grad_of(lookup):
        def g(t, i):
            t = t.detach().requires_grad_()
            return torch.autograd.grad(lookup(t, i).sum(), [t])[0]
        return g

    def fwd_of(lookup):
        def f(t, i):
            with torch.no_grad():
                return lookup(t, i)
        return f

    psum = lambda t, i: sharded_lookup(mesh, t, i)  # noqa: E731
    a2a = lambda t, i: sharded_lookup_a2a(mesh, t, i)  # noqa: E731
    col = lambda t, i: sharded_lookup_column(mesh, t, i)  # noqa: E731
    mb = 1024 * 1024
    where = (f"{n} gloo rank(s) on the CPU: timings directional (the collectives are "
             "memory copies)" if dev.type == "cpu" else
             f"{n} NCCL rank(s), one card each ({torch.cuda.get_device_name(dev)})"
             + (": at one card every collective is a local copy" if n == 1 else ""))
    return {
        "devices": n,
        "vocab": vocab, "dim": dim, "batch": batch, "unique_ids": uniq,
        "note": (f"{where}; traffic model analytic; gspmd: the port's trainers look a "
                 "row-sharded table up through sharded_lookup, so gspmd_* time the psum "
                 "function"),
        "ici_model_mb_per_chip": {
            "psum_or_gspmd": batch * dim * 4 / mb,
            "a2a_dedup": 2 * min(uniq, batch) * dim * 4 / n / mb,
            "column": batch * dim * 4 / mb,
        },
        "wall_ms": {
            "gspmd_fwd": timed(fwd_of(psum), t_row, ids_rep),
            "gspmd_bwd": timed(grad_of(psum), t_row, ids_rep),
            "psum_fwd": timed(fwd_of(psum), t_row, ids_rep),
            "psum_bwd": timed(grad_of(psum), t_row, ids_rep),
            "a2a_fwd": timed(fwd_of(a2a), t_row, ids_sh),
            "a2a_bwd": timed(grad_of(a2a), t_row, ids_sh),
            "column_fwd": timed(fwd_of(col), t_col, ids_sh),
            "column_bwd": timed(grad_of(col), t_col, ids_sh),
        },
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks: every card by default, 8 with --device cpu")
    ap.add_argument("--vocab", type=int, default=262_144)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=65_536)
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="id distribution skew (recsys batches are Zipf)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu for gloo ranks)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device, "lookup_bench")
    world = args.devices or (torch.cuda.device_count() if device.type == "cuda" else 8)
    report = launch(world, _bench_rank, args.vocab, args.dim, args.batch, args.zipf,
                    args.iters, device.type, device=device)
    print(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
