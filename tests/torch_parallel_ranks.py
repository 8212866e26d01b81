"""Run a function on gloo ranks on the CPU, for the port's mesh tests.

``run_ranks(world, fn, inputs)`` spawns ``world`` processes, each of which
joins one gloo process group (a ``file://`` store in a temporary directory),
calls ``fn(rank, inputs)`` and returns what it returns; the parent gets the
list of every rank's results. ``fn`` must live in a module that imports
neither JAX nor the JAX package: a spawned rank imports the module of its
function, and the ranks run the port alone. Inputs and results travel as
``torch.save`` files (tensors, numpy arrays, dicts).
"""

from __future__ import annotations

import importlib
import os
import tempfile

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, root: str, module: str, name: str) -> None:
    torch.set_num_threads(1)
    from recommend_tpu_torch.parallel import multihost_init

    multihost_init(init_method=f"file://{root}/store", world_size=world, rank=rank,
                   backend="gloo")
    import torch.distributed as dist

    try:
        fn = getattr(importlib.import_module(module), name)
        inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        torch.save(fn(rank, inputs), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, inputs=None) -> list:
    with tempfile.TemporaryDirectory() as root:
        torch.save(inputs, os.path.join(root, "inputs.pt"))
        mp.start_processes(_rank_main, args=(world, root, fn.__module__, fn.__name__),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
