"""The trainers' one base: the training step, the state, resume,
checkpoints, the scatter budget and the loop of ``RankingTrainer`` and
``RetrievalTrainer``, on one device or a mesh (``parallel/``).

A trainer sets ``cfg``, ``model`` (on the meta device), ``tables`` (its id
tables' parameter names) and ``optimizer``, and gives the step its own
``_fresh_params``, ``_make_dummies`` (zeros, in a dict or a dict of dicts,
that receive the per-lookup gradients of the id tables), ``_forward`` and
``_apply_sparse_updates``; the other parts of a step and ``init_state``'s
and ``train``'s signatures have defaults it may override.

The state (``TrainState``) is a dict of tensors under the model's state-dict
names, updated IN PLACE by each step and run through
``torch.func.functional_call``. With ``use_sparse_embedding_updates`` the id
tables stay out of autograd and of the dense optimizer, whose state is then
``(its state, {table name: accumulator})``.

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
the rows it owns, in the per-segment order of one device's update; the host
compaction is skipped (the budget compacts the global rows on the device,
as JAX's mesh path does).

A checkpoint is written in the single-device layout: the blocks are
gathered, rank 0 writes, and every rank waits at a barrier; a resume splits
it again. So a run resumes bit-equal into the same mesh, another mesh or
one device, and the other way round. (JAX writes per-host shards through
orbax; one layout is the simpler design while every rank shares a host.)
"""

from __future__ import annotations

import time
from contextlib import ExitStack, contextmanager
from functools import partial
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.models.ranking import batch_block
from recommend_tpu_torch.ops.sparse_embed import (
    compact_valid_rows,
    row_sharded,
    sparse_rowwise_update_table,
    sparse_update_table,
)
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
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from recommend_tpu_torch.utils.logging import MetricLogger
from recommend_tpu_torch.utils.profiling import StepProfiler, count_allocated, span

Tensors = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Tensors  # the model's state-dict names -> tensors
    opt_state: Any  # optimizer state, or (optimizer state, accumulators)
    step: int


class TrainerBase:
    sharded: frozenset = frozenset()

    def __init__(self, cfg, model: torch.nn.Module, mesh, device,
                 checkpoint_dir: Optional[str], log_dir: Optional[str], max_to_keep: int):
        """``device``: the mesh's unless another is named, which raises."""
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        who = type(self).__name__
        if mesh is None:
            self.device = resolve_device(device, who)
        else:
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"{who}: device {device} on a {mesh.device.type} mesh")
            self.device = mesh.device
            # the parameter names split over ``model``, from the model's full shapes
            self.sharded = model_sharded(mesh, dict(model.named_parameters()))
        self.ckpt = CheckpointManager(checkpoint_dir, max_to_keep) if checkpoint_dir else None
        self.logger = MetricLogger(log_dir if self.lead else None, quiet=not self.lead)
        self.history: Dict[str, list] = {"train": [], "val": []}
        self._update = (sparse_rowwise_update_table
                        if cfg.sparse_update_mode == "rowwise" else sparse_update_table)

    # -- the parts of a step a trainer may override ----------------------------
    def _step_draws(self, batch: Dict, generator: Optional[torch.Generator]) -> Any:
        """What a step draws on the host before its forward, handed to
        ``_forward`` and ``_sparse_update``: nothing."""
        return None

    def _dense_update(self, params: Tensors, grads: Tensors, opt_state: dict) -> torch.Tensor:
        """The dense optimizer's step; the gradients' global norm (of the
        full tensors on a mesh), taken first."""
        norm = self._grad_norm(grads)
        self.optimizer.step(params, grads, opt_state)
        return norm

    def _sparse_update(self, params: Tensors, accums: Tensors, gdummies: Dict, batch: Dict,
                       step: int, draws: Any) -> torch.Tensor:
        """``_apply_sparse_updates`` on the global batch with the step's
        draws; the rows the scatter budget dropped."""
        return self._apply_sparse_updates(params, accums, gdummies, self._gather_batch(batch),
                                          draws)

    def _dropped_rows(self, metrics: Tensors, dropped: torch.Tensor) -> None:
        """The rows the scatter budget dropped, a metric when a budget is
        set."""
        if self.cfg.sparse_scatter_budget > 0:
            metrics["sparse_dropped_rows"] = dropped

    # -- state ---------------------------------------------------------------
    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                   opt_state: Optional[dict] = None, accums: Optional[Tensors] = None,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: ``params`` (the model's state dict, e.g. converted
        from a JAX trainer's by ``convert``) or ``_fresh_params(seed)``,
        copied to the device; the dense optimizer state ``opt_state`` (e.g.
        ``convert.retrieval_opt_state_from_flax``'s; its count is the step)
        or a zero one at step 0; with sparse updates, ``accums`` (by table
        parameter name) or 0.1 everywhere ([V] rowwise, [V, D] exact). With
        a ``checkpoint_dir`` that holds a checkpoint, the newest one is
        returned instead (nothing is drawn), and ``generator`` takes the
        state saved with it. On a mesh each of them is given whole and this
        rank keeps its blocks."""
        restored = self.ckpt.restore(map_location=self.device) if self.ckpt else None
        if restored is not None:
            return self._resume(restored, generator)
        if params is None:
            params = self._fresh_params(seed)
        params, opt_state, accums = self._shard_init(params, opt_state, accums)
        state, opt = self._build_state(params, opt_state, accums, self.device)
        dense = opt[0] if self.cfg.use_sparse_embedding_updates else opt
        return TrainState(state, opt, dense["count"])

    def _build_state(self, params: Mapping[str, torch.Tensor], opt_state: Optional[dict],
                     accums: Optional[Tensors], device) -> Tuple[Tensors, Any]:
        """(params on ``device``, the optimizer state that goes with them:
        the dense state ``opt_state`` holds, or a fresh one; with sparse
        updates the accumulators ``accums`` holds, or 0.1 everywhere, [V]
        rowwise and [V, D] exact)."""
        cfg = self.cfg
        frozen = list(self.tables) if cfg.use_sparse_embedding_updates else []
        state: Tensors = {}
        for name, value in params.items():
            t = torch.as_tensor(value).to(device, copy=True)
            state[name] = t.requires_grad_(name not in frozen)
        opt = self.optimizer.init({n: t for n, t in state.items() if n not in frozen})
        if opt_state is not None:
            _load_into(opt, opt_state)
        if frozen:
            if accums is None:
                rowwise = cfg.sparse_update_mode == "rowwise"
                accums = {n: torch.full(state[n].shape[:1] if rowwise else state[n].shape,
                                        0.1, dtype=torch.float32, device=device)
                          for n in frozen}
            else:
                accums = {n: torch.as_tensor(accums[n]).to(device, torch.float32, copy=True)
                          for n in frozen}
            opt = (opt, accums)
        return state, opt

    def _resume(self, restored, generator: Optional[torch.Generator]) -> TrainState:
        """A restored checkpoint as the state, once its layout is the one
        this config builds (built on the meta device to compare: no memory,
        no draws)."""
        like = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in self.model.named_parameters()}
        params, opt_state = self._build_state(like, None, None, "meta")
        try:
            _check_layout(params, restored.params)
            _check_layout(opt_state, restored.opt_state)
        except (KeyError, ValueError, TypeError) as e:
            raise RuntimeError(
                "checkpoint restore failed — the directory holds a state "
                "layout incompatible with this config (different "
                "sparse_update_mode, vocab sizes, or optimizer layout). "
                "Point at a fresh checkpoint_dir or retrain.") from e
        restored_params, opt_state, _ = self._shard_init(restored.params, restored.opt_state)
        for name, t in restored_params.items():
            t.requires_grad_(params[name].requires_grad)
        if generator is not None and restored.rng_state is not None:
            generator.set_state(restored.rng_state.cpu())
        return TrainState(restored_params, opt_state, restored.step)

    def _save(self, state: TrainState, generator: torch.Generator) -> None:
        if self.ckpt is None:
            return
        params, opt_state = self._full_state(state.params, state.opt_state)
        if self.lead:
            self.ckpt.save(state.step, params, opt_state, config_dict=self.cfg.to_dict(),
                           history=self.history, rng_state=generator.get_state())
        if self.mesh is not None:
            self.mesh.barrier()

    # -- the scatter budget ----------------------------------------------------
    def _host_compaction(self, valid: Callable[[], np.ndarray]) -> Tensors:
        """With a scatter budget on one device, the budget's rows chosen on
        the host from the flat validity ``valid()`` of the sparse update's
        rows: ``sparse_scatter_src``, the first ``sparse_scatter_budget``
        valid rows padded with the out-of-range row len(valid), and
        ``sparse_overflow``, the valid rows left out. Nothing otherwise."""
        cfg = self.cfg
        if not (cfg.use_sparse_embedding_updates and cfg.sparse_scatter_budget > 0
                and self.mesh is None):
            return {}
        valid = valid()
        src = np.flatnonzero(valid)
        budget = cfg.sparse_scatter_budget
        idx = np.full(budget, len(valid), np.int64)
        idx[: min(len(src), budget)] = src[:budget]
        return {"sparse_scatter_src": torch.as_tensor(idx).to(self.device),
                "sparse_overflow": torch.tensor(max(len(src) - budget, 0), device=self.device)}

    def _compact(self, ids: torch.Tensor, g: torch.Tensor, batch: Dict, vocab: int,
                 valid: Callable[[], torch.Tensor]):
        """(ids, gradient rows, dropped) cut to the scatter budget: the rows
        ``_host_compaction`` chose, else (on a mesh) the first valid rows by
        ``valid()`` compacted on the device; dropped is None where no budget
        cuts. Slots left empty take the out-of-range id ``vocab`` and zero
        gradients."""
        src = batch.get("sparse_scatter_src")
        if src is not None:
            n = ids.shape[0]
            ok = src < n
            safe = src.clamp_max(n - 1)
            return (torch.where(ok, ids[safe], vocab), g[safe] * ok[:, None].to(g.dtype),
                    batch["sparse_overflow"])
        if 0 < self.cfg.sparse_scatter_budget < ids.shape[0]:
            return compact_valid_rows(ids, g, valid(), self.cfg.sparse_scatter_budget, vocab)
        return ids, g, None

    # -- the step --------------------------------------------------------------
    def _train_step(self, state: TrainState, batch: Dict,
                    generator: Optional[torch.Generator] = None, **inputs):
        """One step on a ``_put_batch`` batch; ``generator`` (CPU) drives
        dropout and ``_step_draws``, which takes ``inputs``. Updates the
        state's tensors in place and returns (the state one step on,
        metrics as device tensors; the losses and accuracies summed over a
        mesh's ``data`` ranks). With the recorder on (``utils/profiling``)
        the step is the span ``train_step`` over ``forward``, ``backward``,
        ``optimizer`` and ``sparse_update``, and counts ``activation_bytes``
        (what the backward holds), ``host_syncs`` and each table's lookups
        and unique rows."""
        params = state.params
        sparse = self.cfg.use_sparse_embedding_updates
        names = [n for n, t in params.items() if t.requires_grad]
        with span("train_step", step=state.step):
            draws = self._step_draws(batch, generator, **inputs)
            with self._on_mesh(params):
                with span("forward"):
                    dummies = self._make_dummies(batch) if sparse else {}
                    loss, metrics = self._forward(params, batch, dummies, generator, draws)
                count_allocated("activation_bytes")
                with span("backward"):
                    grads = torch.autograd.grad(
                        loss, [params[n] for n in names] + _leaves(dummies), allow_unused=True)
                    gparams = {n: torch.zeros_like(params[n]) if g is None else g
                               for n, g in zip(names, grads)}
                    self._reduce_grads(gparams)
            with span("optimizer"):
                metrics["grad_norm"] = self._dense_update(
                    params, gparams, state.opt_state[0] if sparse else state.opt_state)
            if sparse:
                with span("sparse_update"):
                    gdummies = self._gather_batch(_refill(dummies, iter(grads[len(names):])))
                    dropped = self._sparse_update(params, state.opt_state[1], gdummies, batch,
                                                  state.step, draws)
                self._dropped_rows(metrics, dropped)
            metrics = self._reduce_metrics(
                {k: v.detach() for k, v in metrics.items()},
                [k for k in metrics if k.endswith(("loss", "accuracy"))])
        return state._replace(step=state.step + 1), metrics

    # -- the loop --------------------------------------------------------------
    def train(self, train_iter: Iterator[Dict], num_steps: int, val_fn=None,
              eval_every: int = 1000, log_every: int = 100, seed: int = 0,
              profile_dir: Optional[str] = None, profile_start: int = 10,
              profile_num_steps: int = 5) -> TrainState:
        """Train from ``_fresh_params(seed)`` (or the newest checkpoint of
        ``checkpoint_dir``) to step ``num_steps``; ``seed`` also seeds the
        step's generator. Logs every ``log_every`` steps into
        ``history["train"]`` (with ``steps_per_s`` and ``examples_per_s``),
        evaluates ``val_fn()`` every ``eval_every`` steps into
        ``history["val"]``, saves a checkpoint every ``eval_every`` steps and
        at the end. With ``profile_dir`` it writes a ``torch.profiler`` trace
        of steps [profile_start, profile_start + profile_num_steps) after the
        start step there."""
        return self._train(train_iter, num_steps, val_fn, eval_every, log_every, seed,
                           profile_dir, profile_start, profile_num_steps,
                           lambda state, generator, step, vm: self._save(state, generator))

    def _train(self, train_iter: Iterator[Dict], num_steps: int, val_fn, eval_every: int,
               log_every: int, seed: int, profile_dir: Optional[str], profile_start: int,
               profile_num_steps: int,
               at_eval: Callable[[TrainState, torch.Generator, int, Optional[dict]], bool],
               ) -> TrainState:
        """``train``'s loop; every ``eval_every`` steps, after the
        evaluation, ``at_eval(state, generator, step, val metrics or None)``
        saves as the trainer's policy says and returns True to stop."""
        generator = torch.Generator().manual_seed(seed)
        batch = next(train_iter)
        state = self.init_state(seed=seed, generator=generator)
        start_step = state.step
        prof = StepProfiler(profile_dir, start_step + profile_start, profile_num_steps)
        t0 = time.time()
        for i in range(start_step, num_steps):
            with prof.step(i):
                state, metrics = self._train_step(state, self._put_batch(batch), generator)
            if (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                m["steps_per_s"] = log_every / max(dt, 1e-9)
                m["examples_per_s"] = m["steps_per_s"] * self.cfg.batch_size
                self.logger.log("train", i + 1, m)
                self.history["train"].append({"step": i + 1, **m})
                t0 = time.time()
            if (i + 1) % eval_every == 0:
                vm = None
                if val_fn is not None:
                    vm = self.evaluate(state, val_fn())
                    self.logger.log("val", i + 1, vm)
                    self.history["val"].append({"step": i + 1, **vm})
                if at_eval(state, generator, i + 1, vm):
                    break
                if vm is not None:
                    t0 = time.time()
            if i + 1 < num_steps:
                batch = next(train_iter)
        prof.close()
        self._save(state, generator)
        if self.ckpt is not None:
            self.ckpt.wait()  # the saves run in a thread; the last one is on disk
        return state

    # -- the mesh ----------------------------------------------------------------
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

    def _update_rows(self, name: str, table: torch.Tensor, accum: torch.Tensor,
                     ids: torch.Tensor, grads: torch.Tensor, lr) -> None:
        """The sparse-update rule of the global ``ids`` on the rows of
        ``table`` this rank holds; the rest are out of its range and
        dropped. The recorder counts the update's rows under ``name``."""
        if name in self.sharded:
            ids = ids - self.mesh.rank("model") * table.shape[0]
        self._update(table, accum, ids, grads, lr, tag=name)

    def _full_state(self, params: Tensors, opt_state: Any):
        """(params, optimizer state) in the single-device layout."""
        if self.mesh is None:
            return params, opt_state
        return (gather_params(self.mesh, params, self.sharded),
                gather_state(self.mesh, opt_state, self.sharded))


def _leaves(tree) -> list:
    """The tensors of a dict (of dicts) of tensors, in its order."""
    return [t for v in tree.values() for t in _leaves(v)] if isinstance(tree, dict) else [tree]


def _refill(tree, values: Iterator):
    """``tree``'s structure over the next ``values``, in ``_leaves``' order."""
    if isinstance(tree, dict):
        return {k: _refill(v, values) for k, v in tree.items()}
    return next(values)


def _load_into(fresh: dict, given) -> None:
    """Copy the optimizer state ``given`` into ``fresh`` (its layout): the
    tensors in place, the counts as ints."""
    for k, v in fresh.items():
        if isinstance(v, dict):
            _load_into(v, given[k])
        elif isinstance(v, torch.Tensor):
            v.copy_(torch.as_tensor(given[k]))
        else:
            fresh[k] = int(given[k])


def _check_layout(fresh, restored, where: str = "state") -> None:
    """Raise unless ``restored`` has ``fresh``'s structure: the same dict
    keys and sequence lengths, tensors of the same shape and dtype."""
    if isinstance(fresh, torch.Tensor):
        if not isinstance(restored, torch.Tensor):
            raise TypeError(f"{where}: expected a tensor, found {type(restored).__name__}")
        if restored.shape != fresh.shape or restored.dtype != fresh.dtype:
            raise ValueError(f"{where}: {tuple(restored.shape)} {restored.dtype}, expected "
                             f"{tuple(fresh.shape)} {fresh.dtype}")
    elif isinstance(fresh, dict):
        if not isinstance(restored, dict) or set(restored) != set(fresh):
            raise KeyError(f"{where}: keys differ")
        for k in fresh:
            _check_layout(fresh[k], restored[k], f"{where}.{k}")
    elif isinstance(fresh, (tuple, list)):
        if not isinstance(restored, (tuple, list)) or len(restored) != len(fresh):
            raise TypeError(f"{where}: expected a sequence of {len(fresh)}")
        for i, (a, b) in enumerate(zip(fresh, restored)):
            _check_layout(a, b, f"{where}[{i}]")
    elif type(restored) is not type(fresh):
        raise TypeError(f"{where}: {type(restored).__name__}, expected "
                        f"{type(fresh).__name__}")
