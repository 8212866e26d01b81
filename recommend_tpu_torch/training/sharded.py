"""What the two trainers do on a mesh (``parallel/``), in one mixin.

A trainer given a ``Mesh`` holds each rank's block of the state: tables of
at least ``ROW_SHARD_MIN_VOCAB`` rows row-sharded over ``model`` (looked up
through ``parallel.sharded_lookup``), the dedicated NS stacks split over
``model`` on their stack axis (all-gathered for the forward), their
optimizer state and accumulators with them, the rest replicated. Each rank
takes its block of every batch over ``data``; dense gradients are summed
over ``data`` before the clip, whose norm is the full tensors'; dropout
masks are drawn for the global batch and sliced (``models/ranking.py``'s
``batch_block``). The touched-row sparse update runs on the global batch,
its ids and per-lookup gradients gathered over ``data``, each rank writing
the rows it owns, in the per-segment order of one device's update.

A checkpoint is written in the single-device layout: the blocks are
gathered, rank 0 writes, and every rank waits at a barrier; a resume splits
it again. So a run resumes bit-equal into the same mesh, another mesh or
one device, and the other way round. (JAX writes per-host shards through
orbax; one layout is the simpler design while every rank shares a host.)
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from functools import partial
from typing import Any, Dict, Mapping, Optional

import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.models.ranking import batch_block
from recommend_tpu_torch.ops.sparse_embed import row_sharded
from recommend_tpu_torch.parallel.embedding_sharding import sharded_lookup
from recommend_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    gather_params,
    gather_state,
    global_norm,
    is_table,
    model_sharded,
    shard_accums,
    shard_batch,
    shard_params,
    shard_state,
)

Tensors = Dict[str, torch.Tensor]


class ShardedSteps:
    mesh = None
    sharded: frozenset = frozenset()

    def _init_mesh(self, mesh, device, who: str, model: torch.nn.Module) -> None:
        """Set ``mesh``, ``device`` (the mesh's unless another is named,
        which raises) and ``sharded`` (the parameter names split over
        ``model``, from ``model``'s full shapes)."""
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device, who)
            return
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"{who}: device {device} on a {mesh.device.type} mesh")
        self.device = mesh.device
        self.sharded = model_sharded(mesh, dict(model.named_parameters()))

    @property
    def lead(self) -> bool:
        """The rank that writes checkpoints and logs."""
        return self.mesh is None or self.mesh.is_lead

    def _shard_batch(self, batch: Dict) -> Dict:
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def _shard_init(self, params: Mapping, opt_state: Any = None, accums: Any = None):
        """Full params (and optimizer state, accumulators keyed by name) ->
        this rank's blocks."""
        if self.mesh is None:
            return params, opt_state, accums
        params = shard_params(self.mesh, params)
        if opt_state is not None:
            opt_state = shard_state(self.mesh, opt_state, self.sharded)
        if accums is not None:
            accums = shard_accums(self.mesh, accums)
        return params, opt_state, accums

    def _global_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every rank of ``data``, this rank's block cut from
        a tensor drawn for the global batch."""
        if self.mesh is None:
            return x
        return x.chunk(self.mesh.shape["data"])[self.mesh.rank("data")]

    def _gather_batch(self, x):
        """Every rank's block of ``x`` (nested dicts of tensors) over
        ``data``, outside autograd."""
        if self.mesh is None:
            return x
        if isinstance(x, dict):
            return {k: self._gather_batch(v) for k, v in x.items()}
        with torch.no_grad():
            return self.mesh.all_gather(x.detach(), "data")

    @contextmanager
    def _on_mesh(self, params: Tensors):
        """Dropout masks for the global batch, and the row-sharded tables'
        lookups through ``sharded_lookup``."""
        if self.mesh is None:
            yield
            return
        tables = [n for n in self.sharded if is_table(n)]
        with ExitStack() as stack:
            stack.enter_context(batch_block(self.mesh.shape["data"], self.mesh.rank("data")))
            stack.enter_context(row_sharded(
                {params[n]: partial(sharded_lookup, self.mesh) for n in tables}))
            yield

    def _call_params(self, params: Tensors) -> Tensors:
        """The tensors the forward runs on: the NS stacks whole (an
        all-gather over ``model`` whose backward keeps this rank's slice),
        the tables as blocks."""
        if self.mesh is None:
            return params
        return {n: self.mesh.all_gather_invariant(t, "model")
                if n in self.sharded and not is_table(n) else t for n, t in params.items()}

    def _reduce_grads(self, grads: Tensors) -> None:
        if self.mesh is not None:
            all_reduce_grads(self.mesh, grads.values())

    def _grad_norm(self, grads: Tensors) -> torch.Tensor:
        return global_norm(self.mesh, grads, self.sharded)

    def _reduce_metrics(self, metrics: Tensors, names) -> Tensors:
        """Sum each rank's share of the named metrics over ``data``."""
        if self.mesh is not None:
            for k in names:
                if k in metrics:
                    metrics[k] = self.mesh.all_reduce_(metrics[k].detach().clone(), "data")
        return metrics

    def _update_rows(self, update, name: str, table: torch.Tensor, accum: torch.Tensor,
                     ids: torch.Tensor, grads: torch.Tensor, lr) -> None:
        """``update`` (a sparse-update rule) of the global ``ids`` on the
        rows of ``table`` this rank holds; the rest are out of its range
        and dropped. The recorder counts the update's rows under ``name``."""
        if name in self.sharded:
            ids = ids - self.mesh.rank("model") * table.shape[0]
        update(table, accum, ids, grads, lr, tag=name)

    def _full_state(self, params: Tensors, opt_state: Any):
        """(params, optimizer state) in the single-device layout."""
        if self.mesh is None:
            return params, opt_state
        return (gather_params(self.mesh, params, self.sharded),
                gather_state(self.mesh, opt_state, self.sharded))

    def _save_ckpt(self, step: int, params: Tensors, opt_state: Any,
                   rng_state: Optional[torch.Tensor]) -> None:
        if self.ckpt is None:
            return
        params, opt_state = self._full_state(params, opt_state)
        if self.lead:
            self.ckpt.save(step, params, opt_state, config_dict=self.cfg.to_dict(),
                           history=self.history, rng_state=rng_state)
        if self.mesh is not None:
            self.mesh.barrier()
