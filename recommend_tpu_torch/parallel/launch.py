"""Run one function on every rank of a new process group: the launcher of
the port's multi-rank entry points (``examples_torch/lookup_bench.py``,
``examples_torch/scaling_bench.py``, ``graft_entry_torch.dryrun_multichip``).

JAX drives a mesh of devices from one process; the port runs one process
per rank. ``launch(world, fn, *args, device=...)`` joins ``world`` ranks in
one process group (NCCL on the card, one card a rank; gloo on the CPU, one
thread a rank), calls ``fn(*args)`` on each and returns rank 0's result.
One rank runs in this process; more are started with the ``spawn`` method,
so ``fn`` and ``args`` must pickle (``fn`` a module-level function). The
group meets at a ``file://`` store in a temporary directory and is
destroyed when ``fn`` returns or raises; a rank that fails fails the call.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.parallel.mesh import BACKENDS, multihost_init


def _on_rank(rank: int, world: int, root: str, backend: str, fn, args):
    multihost_init(init_method=f"file://{root}/store", world_size=world, rank=rank,
                   backend=backend)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _spawned(rank: int, world: int, root: str, backend: str, fn, args) -> None:
    if backend == "gloo":
        torch.set_num_threads(1)
    result = _on_rank(rank, world, root, backend, fn, args)
    if rank == 0:
        torch.save(result, os.path.join(root, "result.pt"))


def launch(world: int, fn, *args, device=None):
    """``fn(*args)`` on ``world`` ranks of a new process group on ``device``'s
    backend; returns rank 0's result. On CUDA each rank takes its own card,
    so ``world`` may not exceed the cards; a process group that exists
    already raises (its ranks would not be this call's)."""
    dev = resolve_device(device, "launch")
    if dist.is_initialized():
        raise RuntimeError("launch: a process group exists already")
    if world < 1:
        raise ValueError(f"launch: world {world}")
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"launch: {world} ranks on {torch.cuda.device_count()} card(s); "
                         "NCCL takes one card a rank (pass device='cpu' for gloo ranks)")
    backend = BACKENDS[dev.type]
    with tempfile.TemporaryDirectory() as root:
        if world == 1:
            return _on_rank(0, 1, root, backend, fn, args)
        mp.start_processes(_spawned, args=(world, root, backend, fn, args), nprocs=world,
                           join=True, start_method="spawn")
        return torch.load(os.path.join(root, "result.pt"), weights_only=False)
