"""Ranking trainer: the port of the JAX package's
``training/ranking_trainer.RankingTrainer``.

A multi-task BCE loop over ``RankingModel``: global-norm clip and the dense
optimizer (``training/optimizer.py``), touched-row adagrad on the id tables
when ``use_sparse_embedding_updates`` is on (``ops/sparse_embed.py``), dense
adagrad or sgd on them otherwise; streaming AUC in ``evaluate``; best-params
tracking and early stopping in ``train``.

The state is a dict of named tensors (``TrainState.params``, the names of
``RankingModel``'s state dict) that the step updates IN PLACE; the module
itself holds no storage and runs through ``torch.func.functional_call``.
With sparse updates the tables stay outside autograd: zeros "dummies", one
row per lookup, receive the per-lookup gradients, and the optimizer state
is ``(dense optimizer state, {table name: accumulator})`` with the
accumulators at 0.1 (optax's adagrad default), one per row in ``rowwise``
mode.

``model=`` takes any module with ``RankingModel``'s forward signature whose
id tables carry ``RankingModel``'s names under ``tokenizer.`` (the DCNv2+DIN
baseline, ``models/din.py``). ``debug_metrics`` adds training-health scalars
to each step's metrics.

``checkpoint_dir`` (``training/checkpoint.py``): ``init_state`` resumes from
the newest checkpoint there (parameters, optimizer state with its count,
the step, and the dropout generator's state, which JAX needs not keep: it
folds the step into a fixed key); ``train`` saves at every better
evaluation and at the end. ``profile_dir`` traces a window of steps with
``torch.profiler`` (``utils/profiling.py``).

The trainer runs on CUDA unless given ``device="cpu"``; with no device
given and no CUDA available it raises. With a ``mesh``
(``parallel.make_mesh``) it runs on the mesh's device, one process per
rank, every rank given the same host batches (``training/sharded.py``): a
step computes what one device computes on the whole batch. The loss of each
rank is its share of the global batch's mean, the host compaction is
skipped (the budget compacts the global rows on the device, as JAX's mesh
path does), and ``evaluate`` scores the global batch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import init_params, table_param_names
from recommend_tpu_torch.models.losses import multi_task_bce_loss
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.ops.sparse_embed import (
    compact_valid_rows,
    make_dummy,
    sparse_rowwise_update_table,
    sparse_update_table,
)
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from recommend_tpu_torch.training.metrics import streaming_auc
from recommend_tpu_torch.training.optimizer import make_ranking_optimizer, sparse_lr_schedule
from recommend_tpu_torch.training.sharded import ShardedSteps
from recommend_tpu_torch.utils.logging import MetricLogger
from recommend_tpu_torch.utils.profiling import StepProfiler

Tensors = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Tensors  # the model's state-dict names -> tensors
    opt_state: Any  # optimizer state, or (optimizer state, accumulators)
    step: int


class RankingTrainer(ShardedSteps):
    def __init__(
        self,
        cfg: RankingConfig,
        checkpoint_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        mesh=None,
        model: Optional[torch.nn.Module] = None,
        total_steps: int = 0,
        debug_metrics: bool = False,
        device=None,
        max_to_keep: int = 5,
    ):
        """``total_steps`` feeds the cosine dense-LR schedule.
        ``debug_metrics`` adds max |task logit|, the item table's RMS and
        the dense parameters' norm to each step's metrics (the table RMS
        reads the whole table every step). ``max_to_keep``: checkpoints
        kept in ``checkpoint_dir``."""
        self.cfg = cfg
        if model is None:
            with torch.device("meta"):
                model = RankingModel(cfg)
        self.model = model
        self._init_mesh(mesh, device, "RankingTrainer", model)
        self.debug_metrics = debug_metrics
        self.ckpt = CheckpointManager(checkpoint_dir, max_to_keep) if checkpoint_dir else None
        self.tables = table_param_names(cfg)
        self._ns_tables = dict(zip(cfg.non_seq_features, self.tables))  # feature -> table
        self._item_table = self.tables[-1] if cfg.sequence_features else None
        self.optimizer = make_ranking_optimizer(cfg, total_steps, self.tables)
        self.logger = MetricLogger(log_dir if self.lead else None, quiet=not self.lead)
        self.history: Dict[str, list] = {"train": [], "val": []}
        self._auc = streaming_auc(device=self.device)
        self._sparse_lr = sparse_lr_schedule(cfg)
        self._update = (sparse_rowwise_update_table
                        if cfg.sparse_update_mode == "rowwise" else sparse_update_table)

    # -- batches and state --------------------------------------------------
    def _seq_names_of(self, batch) -> list:
        """The sequence-feature row layout shared by the dummies, the sparse
        update and the host-side compaction indices."""
        return [sf for sf in self.cfg.sequence_features if sf in batch["sequences"]]

    def _put_batch(self, batch: Dict) -> Dict:
        """A numpy batch -> tensors on the trainer's device (ids int64, the
        semantic features' [B, dim] vectors float32, validity bool, labels
        float32), with the sparse-scatter compaction indices precomputed on
        the host when a budget is set. On a mesh: this rank's block, not
        compacted."""
        cfg = self.cfg
        dev = self.device
        batch = self._shard_batch(batch)
        semantic = {name for name, _ in cfg.semantic_features}

        def put(group, dtype):
            return {k: torch.as_tensor(np.asarray(v)).to(
                        dev, torch.float32 if group == "non_seq" and k in semantic else dtype)
                    for k, v in batch[group].items()}

        out = {"non_seq": put("non_seq", torch.long),
               "sequences": put("sequences", torch.long),
               "seq_valid": put("seq_valid", torch.bool),
               "labels": put("labels", torch.float32)}
        if (cfg.use_sparse_embedding_updates and cfg.sparse_scatter_budget > 0
                and batch.get("sequences") and self.mesh is None):
            valid = np.concatenate([np.asarray(batch["seq_valid"][sf]).reshape(-1)
                                    for sf in self._seq_names_of(batch)])
            src = np.flatnonzero(valid)
            budget = cfg.sparse_scatter_budget
            idx = np.full(budget, len(valid), np.int64)
            idx[: min(len(src), budget)] = src[:budget]
            out["sparse_scatter_src"] = torch.as_tensor(idx).to(dev)
            out["sparse_overflow"] = torch.tensor(max(len(src) - budget, 0), device=dev)
        return out

    def init_state(self, params: Optional[Tensors] = None, seed: int = 0,
                   accums: Optional[Tensors] = None,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: ``params`` (the model's state dict, e.g. from
        ``convert.params_from_flax``) or ``init_params(cfg, seed)``, copied
        to the device; a zero optimizer state; with sparse updates,
        ``accums`` (by table parameter name) or 0.1 everywhere. With a
        ``checkpoint_dir`` that holds a checkpoint, the newest one is
        returned instead (nothing is drawn), and ``generator`` takes the
        dropout state saved with it. On a mesh they are given whole and
        this rank keeps its blocks."""
        restored = self.ckpt.restore(map_location=self.device) if self.ckpt else None
        if restored is not None:
            return self._resume(restored, generator)
        if params is None:
            params = init_params(self.cfg, seed=seed, device=self.device, model=self.model)
        params, _, accums = self._shard_init(params, None, accums)
        return TrainState(*self._build_state(params, accums, self.device), 0)

    def _build_state(self, params: Mapping[str, torch.Tensor], accums: Optional[Tensors],
                     device) -> Tuple[Tensors, Any]:
        """(params on ``device``, the optimizer state that goes with them)."""
        cfg = self.cfg
        sparse = cfg.use_sparse_embedding_updates
        state: Tensors = {}
        for name, value in params.items():
            t = torch.as_tensor(value).to(device, copy=True)
            state[name] = t.requires_grad_(not (sparse and name in self.tables))
        dense = {n: t for n, t in state.items() if not (sparse and n in self.tables)}
        opt_state = self.optimizer.init(dense)
        if sparse:
            if accums is None:
                rowwise = cfg.sparse_update_mode == "rowwise"
                accums = {n: torch.full(state[n].shape[:1] if rowwise else state[n].shape,
                                        0.1, dtype=torch.float32, device=device)
                          for n in self.tables}
            else:
                accums = {n: torch.as_tensor(accums[n]).to(device, torch.float32,
                                                           copy=True)
                          for n in self.tables}
            opt_state = (opt_state, accums)
        return state, opt_state

    def _resume(self, restored, generator: Optional[torch.Generator]) -> TrainState:
        """A restored checkpoint as the state, once its layout is the one
        this config builds (built on the meta device to compare: no memory,
        no draws)."""
        like = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in self.model.named_parameters()}
        params, opt_state = self._build_state(like, None, "meta")
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

    # -- steps ---------------------------------------------------------------
    def _logits(self, params: Tensors, batch: Dict, **kwargs) -> Tensors:
        return functional_call(
            self.model, self._call_params(params),
            (batch["non_seq"], batch["sequences"], batch["seq_valid"]), kwargs)

    def _make_dummies(self, batch: Dict) -> Tensors:
        """Zeros that receive the per-lookup embedding gradients."""
        cfg = self.cfg
        d = {f"ns_{f}": make_dummy(batch["non_seq"][f].shape, cfg.feature_embed_dim,
                                   device=self.device)
             for f in cfg.non_seq_features}
        for sf in self._seq_names_of(batch):
            d[f"seq_{sf}"] = make_dummy(batch["sequences"][sf].shape,
                                        cfg.seq_item_feature_dim, device=self.device)
        return d

    @torch.no_grad()
    def _apply_sparse_updates(self, params: Tensors, accums: Tensors,
                              gdummies: Tensors, batch: Dict, lr: float) -> torch.Tensor:
        """Touched-row adagrad on every table, in place; returns the number
        of rows the scatter budget dropped. On a mesh the batch and the
        gradients given are the global ones."""
        cfg = self.cfg
        dropped = torch.zeros((), dtype=torch.long, device=self.device)
        seq_names = self._seq_names_of(batch)
        if seq_names:
            item_vocab = cfg.vocab_size("item_id")
            # padded positions carry exactly-zero gradients; their ids go to
            # the out-of-range sentinel, whose writes are dropped
            ids = torch.cat([
                torch.where(batch["seq_valid"][sf], batch["sequences"][sf],
                            item_vocab).reshape(-1) for sf in seq_names])
            g = torch.cat([gdummies[f"seq_{sf}"].reshape(-1, cfg.seq_item_feature_dim)
                           for sf in seq_names])
            src = batch.get("sparse_scatter_src")
            if src is not None:
                n = ids.shape[0]
                ok = src < n
                safe = src.clamp_max(n - 1)
                ids = torch.where(ok, ids[safe], item_vocab)
                g = g[safe] * ok[:, None].to(g.dtype)
                dropped = batch["sparse_overflow"]
            elif 0 < cfg.sparse_scatter_budget < ids.shape[0]:
                valid = torch.cat([batch["seq_valid"][sf].reshape(-1) for sf in seq_names])
                ids, g, dropped = compact_valid_rows(
                    ids, g, valid, cfg.sparse_scatter_budget, item_vocab)
            name = self._item_table
            self._update_rows(self._update, name, params[name], accums[name], ids, g, lr)
        for f, name in self._ns_tables.items():
            self._update_rows(self._update, name, params[name], accums[name],
                              batch["non_seq"][f], gdummies[f"ns_{f}"], lr)
        return dropped

    def _train_step(self, state: TrainState, batch: Dict,
                    generator: Optional[torch.Generator] = None):
        """One step on a ``_put_batch`` batch; ``generator`` (CPU) drives
        dropout. Updates the state's tensors in place and returns
        (the state one step on, metrics as device tensors)."""
        cfg = self.cfg
        params = state.params
        sparse = cfg.use_sparse_embedding_updates
        dummies = self._make_dummies(batch) if sparse else {}
        names = [n for n, t in params.items() if t.requires_grad]
        with self._on_mesh(params):
            logits = self._logits(params, batch, deterministic=False,
                                  dummies=dummies or None, generator=generator)
            loss, metrics = multi_task_bce_loss(logits, batch["labels"])
            if self.mesh is not None:  # this rank's share of the global mean
                share = 1.0 / self.mesh.shape["data"]
                loss = loss * share
                metrics = {k: v * share for k, v in metrics.items()}
            grads = torch.autograd.grad(
                loss, [params[n] for n in names] + list(dummies.values()), allow_unused=True)
        gparams = {n: torch.zeros_like(params[n]) if g is None else g
                   for n, g in zip(names, grads)}
        self._reduce_grads(gparams)
        if self.debug_metrics:
            self._add_debug_metrics(metrics, logits, params)
        opt_state = state.opt_state[0] if sparse else state.opt_state
        metrics["grad_norm"] = self.optimizer.step(params, gparams, opt_state,
                                                   self._grad_norm(gparams))
        if sparse:
            gdummies = self._gather_batch(dict(zip(dummies, grads[len(names):])))
            dropped = self._apply_sparse_updates(
                params, state.opt_state[1], gdummies, self._gather_batch(
                    {k: batch[k] for k in ("non_seq", "sequences", "seq_valid")}
                    if self.mesh is not None else batch),
                self._sparse_lr(state.step) if callable(self._sparse_lr) else self._sparse_lr)
            if cfg.sparse_scatter_budget > 0:
                metrics["sparse_dropped_rows"] = dropped
        metrics = self._reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                       [k for k in metrics if k.endswith("loss")])
        return state._replace(step=state.step + 1), metrics

    @torch.no_grad()
    def _add_debug_metrics(self, metrics: Dict, logits: Tensors, params: Tensors) -> None:
        """Training-health scalars of the parameters the step started from:
        max |logit| per task, the item table's RMS, the dense parameters'
        global norm (on a mesh, of the global batch and the full tensors)."""
        for t, l in self._gather_batch(logits).items():
            metrics[f"{t}_logit_max"] = l.abs().max()
        if self._item_table is not None:
            item = params[self._item_table]
            if self._item_table in self.sharded:
                sq = self.mesh.all_reduce_(item.float().square().sum(), "model")
                metrics["item_table_rms"] = (sq / (item.numel() * self.mesh.shape["model"])).sqrt()
            else:
                metrics["item_table_rms"] = item.float().square().mean().sqrt()
        sparse = self.cfg.use_sparse_embedding_updates
        metrics["dense_param_norm"] = self._grad_norm(
            {n: t for n, t in params.items() if not (sparse and n in self.tables)})

    @torch.no_grad()
    def _eval_step(self, params: Tensors, batch: Dict, auc_states):
        """Loss and AUC of a ``_put_batch`` batch (on a mesh, of the global
        batch: the logits and labels are gathered)."""
        with self._on_mesh(params):
            logits = self._gather_batch(self._logits(params, batch))
        labels = self._gather_batch(batch["labels"])
        _, metrics = multi_task_bce_loss(logits, labels)
        _, update, _ = self._auc
        new_states = {t: update(auc_states[t], torch.sigmoid(logits[t]), labels[t])
                      for t in logits}
        return metrics, new_states

    # -- loops ---------------------------------------------------------------
    def evaluate(self, state: TrainState, val_batches: Iterator[Dict]) -> Dict[str, float]:
        init, _, compute = self._auc
        auc_states = {t: init() for t in self.cfg.tasks}
        accum: Dict[str, list] = {}
        for batch in val_batches:
            metrics, auc_states = self._eval_step(state.params, self._put_batch(batch),
                                                  auc_states)
            for k, v in metrics.items():
                accum.setdefault(k, []).append(float(v))
        out = {k: float(np.mean(v)) for k, v in accum.items()}
        for t in self.cfg.tasks:
            out[f"{t}_auc"] = float(compute(auc_states[t]))
        return out

    def train(
        self,
        train_iter: Iterator[Dict],
        num_steps: int,
        val_fn=None,
        eval_every: int = 1000,
        log_every: int = 100,
        early_stop_patience: Optional[int] = None,
        seed: int = 0,
        profile_dir: Optional[str] = None,
        profile_start: int = 10,
        profile_num_steps: int = 5,
        track_best_params: bool = False,
    ) -> TrainState:
        """Train from ``init_params(cfg, seed)`` (or the newest checkpoint
        of ``checkpoint_dir``) to step ``num_steps``; ``seed`` also seeds
        the dropout generator. Logs every
        ``log_every`` steps into ``history["train"]``, evaluates
        ``val_fn()`` every ``eval_every`` steps into ``history["val"]``, stops
        after ``early_stop_patience`` evaluations without a better
        primary-task AUC, and with ``track_best_params`` keeps a copy of the
        best evaluation's params in ``best_params`` (with
        ``best_val_step``, ``best_val_metrics``). With a ``checkpoint_dir``
        it saves at every better evaluation and at the end. With
        ``profile_dir`` it writes a ``torch.profiler`` trace of steps
        [profile_start, profile_start + profile_num_steps) after the start
        step there."""
        generator = torch.Generator().manual_seed(seed)
        batch = next(train_iter)
        state = self.init_state(seed=seed, generator=generator)
        start_step = state.step
        prof = StepProfiler(profile_dir, start_step + profile_start, profile_num_steps)
        best_val = -float("inf")
        self.best_params = None
        self.best_val_step = None
        self.best_val_metrics = None
        bad_evals = 0
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
            if val_fn is not None and (i + 1) % eval_every == 0:
                vm = self.evaluate(state, val_fn())
                self.logger.log("val", i + 1, vm)
                self.history["val"].append({"step": i + 1, **vm})
                primary = vm.get(f"{self.cfg.tasks[0]}_auc", -vm.get("loss", 0.0))
                if primary > best_val:
                    best_val = primary
                    bad_evals = 0
                    if track_best_params:
                        # copies: the step updates the state's tensors in place
                        self.best_params = {k: v.detach().clone()
                                            for k, v in state.params.items()}
                        self.best_val_step = i + 1
                        self.best_val_metrics = dict(vm)
                    self._save(state, generator)
                else:
                    bad_evals += 1
                    if early_stop_patience and bad_evals >= early_stop_patience:
                        break
                t0 = time.time()
            if i + 1 < num_steps:
                batch = next(train_iter)
        prof.close()
        self._save(state, generator)
        if self.ckpt is not None:
            self.ckpt.wait()  # the saves run in a thread; the last one is on disk
        return state

    def _save(self, state: TrainState, generator: torch.Generator) -> None:
        self._save_ckpt(state.step, state.params, state.opt_state, generator.get_state())


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
