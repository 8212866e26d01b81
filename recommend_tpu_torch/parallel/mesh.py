"""The device mesh and process-group init: the port of the JAX package's
``parallel/mesh.py``.

JAX is single-controller: one process sees every device and ``shard_map``
runs a function on each. The port is SPMD in PyTorch's idiom: one process
per rank, every rank builds the same objects and calls the same entry
points with the same host inputs, and collectives run on process groups. A
``Mesh`` is a 2-axis ``('data', 'model')`` ``DeviceMesh``: ``data`` for the
batch (gradients summed over it), ``model`` for row-sharded embedding tables
and the dedicated NS stacks. Ranks are laid out data-major, as JAX's
``make_mesh`` reshapes its devices: rank = data index * model + model index.

The collectives the sharded paths run are methods of the mesh, each
differentiable where a gradient crosses it, its backward the transpose of
its forward:

- ``psum``: all-reduce; backward the identity (every rank of the axis
  consumes the same sum, so each holds the whole cotangent);
- ``all_gather``: tiled on dim 0; backward reduce-scatter (each rank
  consumes the gathered tensor differently: the in-batch negatives);
- ``all_gather_invariant``: tiled on dim 0 for consumers that compute the
  same thing on every rank of the axis (the NS stacks on ``model``);
  backward the rank's own slice of the cotangent (JAX's
  ``all_gather_invariant``; a reduce-scatter would count it once per rank);
- ``all_to_all``: equal chunks of dim 0 exchanged; backward the reverse
  exchange, which is the same one.

``all_reduce_`` sums in place outside autograd (gradients, metrics).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from recommend_tpu_torch._device import resolve_device

AXES = ("data", "model")
# the backend each device type runs its collectives on; no other is taken
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def multihost_init(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Initialize the default process group (``init_process_group``).

    Idempotent: a group that exists is kept. With no ``init_method``,
    ``world_size`` or ``rank`` it reads ``env://`` when ``RANK`` and
    ``WORLD_SIZE`` are set and is a no-op otherwise (a single process has
    nothing to join). ``backend`` defaults to NCCL, which needs CUDA; gloo
    runs only when named. When arguments were given explicitly, a failure
    re-raises: a silent single-process run would hang at the first
    collective or train on 1/N of the data with no error at the fault."""
    if dist.is_initialized():
        return
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return
    try:
        dist.init_process_group(backend or "nccl", init_method=init_method or "env://",
                                world_size=-1 if world_size is None else world_size,
                                rank=-1 if rank is None else rank)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"init_process_group failed with init_method={init_method!r}, "
            f"world_size={world_size}, rank={rank}, backend={backend!r}; refusing to "
            "silently fall back to single-process") from e


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# torch 2.13 renames the tensor forms of all-gather and reduce-scatter
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // ctx.n,) + tuple(g.shape[1:]))
        _reduce_scatter_single(out, g.contiguous(), group=ctx.group)
        return out, None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.rows, ctx.index = x.shape[0], index
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class Mesh:
    """A ``('data', 'model')`` mesh of ranks, and its collectives."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _Psum.apply(x, self.group(axis))

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _AllGather.apply(x, self.group(axis), self.shape[axis])

    def all_gather_invariant(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _AllGatherInvariant.apply(x, self.group(axis), self.shape[axis],
                                         self.rank(axis))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _AllToAll.apply(x, self.group(axis))

    def all_reduce_(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        dist.all_reduce(x, group=self.group(axis))
        return x

    @property
    def is_lead(self) -> bool:
        """Rank 0 of the world: the one that writes files."""
        return dist.get_rank() == 0

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device})"


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh over every rank of the default process
    group (``multihost_init`` first). ``data=None`` infers data = world //
    model. The ranks run on CUDA over NCCL unless ``device="cpu"`` names
    gloo; with no device named and no CUDA this raises, and a process group
    whose backend is not the device's raises too (no fallback)."""
    dev = resolve_device(device, "make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call multihost_init first")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"make_mesh: a {dev.type} mesh runs on {BACKENDS[dev.type]}, "
                           f"the process group on {backend}")
    n = dist.get_world_size()
    if data is None:
        assert n % model == 0, (n, model)
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} ranks"
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES), dev)
