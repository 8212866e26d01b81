"""The retrieval trainer: the port of the JAX package's
``training/trainer.RetrievalTrainer``.

In-batch sampled softmax over ``RetrievalTower`` (LogQ correction, label
smoothing; ``models/losses.py``), the tower's adamw on a warmup-cosine
schedule (``training/optimizer.make_retrieval_optimizer``), in-batch HR@K
in ``evaluate``, checkpoints and a metric history in ``train``. Three modes:

- ``single``: one prediction per history (``RetrievalTower.forward``)
  against the held-out target;
- ``seq2seq``: every position of the raw (uncompressed) tail predicts its
  next item, in one pass (``all_position_interests``); the last position's
  next item is the target;
- ``masked``: M = max(1, min(8, R - 1)) positions of the raw tail become the
  [MASK] token and are predicted bidirectionally
  (``masked_position_outputs``). JAX draws them with
  ``jax.random.randint`` from the step's key, which torch cannot reproduce:
  here they come from the trainer's ``torch.Generator`` (the stream that
  seeds dropout), once per step for the loss and the sparse update alike,
  and a step may be handed them (``mask_positions``).

The state is a dict of tensors under ``RetrievalTower``'s state-dict names
(the names ``RetrievalIndex.refresh`` takes), updated IN PLACE by each step
and run through ``torch.func.functional_call``. With
``use_sparse_embedding_updates`` the three id tables stay out of autograd
and out of adamw: zeros "dummies" receive the per-lookup gradients of the
history and of the targets, padded history positions (and seq2seq targets
without a valid next item) go to the out-of-range sentinel, and each table
takes touched-row adagrad (``ops/sparse_embed.py``, exact or rowwise, at
``sparse_embedding_lr``, accumulators from 0.1) on its ``[history ;
target]`` rows, compacted to ``sparse_scatter_budget`` rows on the host in
``_put_batch`` when a budget is set (``compact_valid_rows`` on the device
otherwise); the optimizer state is then ``(adamw state, {table name:
accumulator})``. ``grad_norm`` is the global norm of the dense gradients.

``checkpoint_dir`` (``training/checkpoint.py``): ``init_state`` resumes from
the newest checkpoint there (parameters, adamw moments and count,
accumulators, the step and the generator's state); ``train`` saves every
``eval_every`` steps and at the end. ``init_state`` also takes a JAX
trainer's converted state (``convert.retrieval_params_from_flax``,
``convert.retrieval_opt_state_from_flax``), so a JAX run continues here.

The trainer runs on CUDA unless given ``device="cpu"``; with no device given
and no CUDA available it raises. With a ``mesh`` (``parallel.make_mesh``) it
runs on the mesh's device, one process per rank, every rank given the same
host batches (``training/sharded.py``): a step computes what one device
computes on the whole batch. The in-batch losses score each rank's rows
against every rank's candidates (``models/losses.py``), the masked positions
are drawn for the global batch and sliced, and the host compaction is
skipped: the budget compacts the global rows on the device, as JAX's mesh
path does.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.convert import init_retrieval_params
from recommend_tpu_torch.models.losses import in_batch_softmax_loss, seq2seq_in_batch_loss
from recommend_tpu_torch.models.retrieval import RetrievalTower
from recommend_tpu_torch.ops.embedding import SPARSE_TABLES
from recommend_tpu_torch.ops.sparse_embed import (
    compact_valid_rows,
    make_dummy,
    sparse_rowwise_update_table,
    sparse_update_table,
)
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from recommend_tpu_torch.training.metrics import retrieval_metric_suite
from recommend_tpu_torch.training.optimizer import make_retrieval_optimizer
from recommend_tpu_torch.training.ranking_trainer import TrainState, _check_layout
from recommend_tpu_torch.training.sharded import ShardedSteps
from recommend_tpu_torch.utils.logging import MetricLogger
from recommend_tpu_torch.utils.profiling import StepProfiler, count, count_allocated, span

Tensors = Dict[str, torch.Tensor]


class _Apply(nn.Module):
    """Calls ``fn(tower, *args)``: one ``functional_call`` runs whichever
    tower methods a loss needs on the state's tensors."""

    def __init__(self, tower: RetrievalTower):
        super().__init__()
        self.tower = tower

    def forward(self, fn, *args):
        return fn(self.tower, *args)


class RetrievalTrainer(ShardedSteps):
    def __init__(
        self,
        cfg: RetrievalConfig,
        total_steps: int = 100_000,
        checkpoint_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        mesh=None,
        mode: str = "single",
        device=None,
        max_to_keep: int = 5,
    ):
        """``total_steps`` feeds the cosine schedule; ``mode`` is
        ``single``, ``seq2seq`` or ``masked``; ``max_to_keep``: checkpoints
        kept in ``checkpoint_dir``."""
        assert mode in ("single", "seq2seq", "masked"), mode
        self.cfg = cfg
        self.mode = mode
        with torch.device("meta"):
            self.model = RetrievalTower(cfg)
        self._init_mesh(mesh, device, "RetrievalTrainer", self.model)
        self._apply = _Apply(self.model)
        self.tables = {n: f"embed.tables.{n}.weight" for n in SPARSE_TABLES}
        self.optimizer = make_retrieval_optimizer(cfg, total_steps, self.tables.values())
        self.ckpt = CheckpointManager(checkpoint_dir, max_to_keep) if checkpoint_dir else None
        self.logger = MetricLogger(log_dir if self.lead else None, quiet=not self.lead)
        self.history: Dict[str, list] = {"train": [], "val": []}
        # the raw (uncompressed) tail: the seq2seq and masked positions
        last = cfg.schedule_specs()[-1]
        self.tail_r = last.num_tokens if last.group_size == 1 else 0
        self.num_mask = max(1, min(8, self.tail_r - 1))
        if mode != "single":
            assert self.tail_r > 1, f"{mode} mode needs a raw (group_size=1) tail segment"
        self._vocab = {"video_id": cfg.video_vocab_size, "category": cfg.category_vocab_size,
                       "tag": cfg.tag_vocab_size}
        self._update = (sparse_rowwise_update_table
                        if cfg.sparse_update_mode == "rowwise" else sparse_update_table)

    # -- batches and state --------------------------------------------------
    def _target_valid(self, hv):
        """Validity of the target rows of the sparse update ([B, R] seq2seq:
        a next item exists; all valid otherwise), host or device."""
        b, l = hv.shape
        r = self.tail_r
        if self.mode == "seq2seq":
            if isinstance(hv, np.ndarray):
                return np.concatenate([hv[:, l - r + 1:], np.ones((b, 1), bool)], axis=1)
            return torch.cat([hv[:, l - r + 1:], hv.new_ones((b, 1))], dim=1)
        return None

    def _put_batch(self, batch: Dict) -> Dict:
        """A numpy batch -> tensors on the trainer's device (ids int64,
        ``duration`` and popularities float32, validity bool), with the
        sparse-scatter compaction precomputed on the host when a budget is
        set: the valid rows of ``[history ; target]``, in that layout. On a
        mesh: this rank's block, not compacted."""
        cfg = self.cfg
        dev = self.device
        batch = self._shard_batch(batch)

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

        def feats(group):
            return {k: put(v, torch.float32 if k == "duration" else torch.long)
                    for k, v in group.items()}

        out = {"history": feats(batch["history"]), "target": feats(batch["target"]),
               "history_valid": put(batch["history_valid"], torch.bool)}
        for k in ("target_popularity", "history_popularity"):
            if k in batch:
                out[k] = put(batch[k], torch.float32)
        if (cfg.use_sparse_embedding_updates and cfg.sparse_scatter_budget > 0
                and self.mesh is None):
            hv = np.asarray(batch["history_valid"])
            b = hv.shape[0]
            tv = self._target_valid(hv)
            if tv is None:
                tv = np.ones((b, self.num_mask if self.mode == "masked" else 1), bool)
            valid = np.concatenate([hv.reshape(-1), tv.reshape(-1)])
            src = np.flatnonzero(valid)
            budget = cfg.sparse_scatter_budget
            idx = np.full(budget, len(valid), np.int64)
            idx[: min(len(src), budget)] = src[:budget]
            out["sparse_scatter_src"] = torch.as_tensor(idx).to(dev)
            out["sparse_overflow"] = torch.tensor(max(len(src) - budget, 0), device=dev)
        return out

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                   opt_state: Optional[dict] = None, accums: Optional[Tensors] = None,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: ``params`` (the tower's state dict, e.g. from
        ``convert.retrieval_params_from_flax``) or
        ``init_retrieval_params(cfg, seed)``, copied to the device; the
        adamw state ``opt_state`` (``{"count", "mu", "nu"}``, e.g. from
        ``convert.retrieval_opt_state_from_flax``; its count is the step)
        or zero moments at step 0; with sparse updates, ``accums`` (by table
        parameter name) or 0.1 everywhere ([V] rowwise, [V, D] exact). With
        a ``checkpoint_dir`` that holds a checkpoint, the newest one is
        returned instead, and ``generator`` takes the state saved with it.
        On a mesh each of them is given whole and this rank keeps its
        blocks."""
        restored = self.ckpt.restore(map_location=self.device) if self.ckpt else None
        if restored is not None:
            return self._resume(restored, generator)
        if params is None:
            params = init_retrieval_params(self.cfg, seed=seed, device=self.device)
        params, opt_state, accums = self._shard_init(params, opt_state, accums)
        state, opt = self._build_state(params, opt_state, accums, self.device)
        return TrainState(state, opt, 0 if opt_state is None else int(opt_state["count"]))

    def _build_state(self, params, opt_state, accums, device):
        """(params on ``device``, the optimizer state that goes with them)."""
        cfg = self.cfg
        sparse = cfg.use_sparse_embedding_updates
        frozen = set(self.tables.values()) if sparse else set()
        state: Tensors = {}
        for name, value in params.items():
            t = torch.as_tensor(value).to(device, copy=True)
            state[name] = t.requires_grad_(name not in frozen)
        dense = {n: t for n, t in state.items() if n not in frozen}
        opt = self.optimizer.init(dense)
        if opt_state is not None:
            opt["count"] = int(opt_state["count"])
            for moment in ("mu", "nu"):
                for n, t in opt[moment].items():
                    t.copy_(torch.as_tensor(opt_state[moment][n]))
        if sparse:
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
        this config builds (compared on the meta device)."""
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

    # -- losses --------------------------------------------------------------
    def _next_feats(self, batch: Dict) -> Tensors:
        """seq2seq: each tail position's next item, the history shifted by
        one with the target last -> [B, R] features."""
        r, l = self.tail_r, self.cfg.max_seq_len
        return {k: torch.cat([v[:, l - r + 1:], batch["target"][k][:, None]], dim=1)
                for k, v in batch["history"].items()}

    def draw_mask_positions(self, batch_size: int,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, M] raw positions inside the uncompressed tail, uniform, drawn
        from ``generator`` (a CPU one; the default generator when None)."""
        r, l = self.tail_r, self.cfg.max_seq_len
        u = torch.randint(0, r, (batch_size, self.num_mask), generator=generator)
        return (l - r + u).to(self.device)

    def _target_feats(self, batch: Dict, pos: Optional[torch.Tensor]) -> Tensors:
        if self.mode == "seq2seq":
            return self._next_feats(batch)
        if self.mode == "masked":
            return {k: torch.gather(v, 1, pos) for k, v in batch["history"].items()}
        return batch["target"]

    def _loss(self, tower: RetrievalTower, batch: Dict, dummies, generator, pos):
        cfg = self.cfg
        hist, hv = batch["history"], batch["history_valid"]
        dh = None if dummies is None else dummies["hist"]
        dt = None if dummies is None else dummies["tgt"]
        logq = cfg.use_logq_correction
        target_emb = tower.item_embeddings(self._target_feats(batch, pos), dt)
        if self.mode == "single":
            interests = tower(hist, hv, deterministic=False, dummies=dh, generator=generator)
            pop = batch["target_popularity"] if logq else None
            return in_batch_softmax_loss(interests, target_emb, pop,
                                         label_smoothing=cfg.label_smoothing, mesh=self.mesh)
        r, l = self.tail_r, cfg.max_seq_len
        if self.mode == "seq2seq":
            t = cfg.num_compressed_tokens
            interests = tower.all_position_interests(
                hist, hv, deterministic=False, dummies=dh, generator=generator)[:, t - r:]
            pos_valid = hv[:, l - r:] & self._target_valid(hv)
            pop = None
            if logq:
                pop = torch.cat([batch["history_popularity"][:, l - r + 1:],
                                 batch["target_popularity"][:, None]], dim=1)
        else:
            interests = tower.masked_position_outputs(
                hist, hv, pos, deterministic=False, dummies=dh,
                generator=generator)[:, :, None, :]
            pos_valid = torch.gather(hv, 1, pos)
            pop = torch.gather(batch["history_popularity"], 1, pos) if logq else None
        return seq2seq_in_batch_loss(interests, target_emb, pop, pos_valid,
                                     label_smoothing=cfg.label_smoothing, mesh=self.mesh)

    def _make_dummies(self, batch: Dict) -> Dict[str, Tensors]:
        """Zeros that receive the per-lookup gradients of the id tables:
        [B, L, D] for the history, [B, D] / [B, R, D] / [B, M, D] for the
        targets by mode."""
        d = self.cfg.embed_dim
        b, l = batch["history_valid"].shape
        tgt = {"single": (b,), "seq2seq": (b, self.tail_r), "masked": (b, self.num_mask)}
        return {"hist": {k: make_dummy((b, l), d, device=self.device) for k in SPARSE_TABLES},
                "tgt": {k: make_dummy(tgt[self.mode], d, device=self.device)
                        for k in SPARSE_TABLES}}

    # -- steps ---------------------------------------------------------------
    @torch.no_grad()
    def _apply_sparse_updates(self, params: Tensors, accums: Tensors,
                              gdummies: Dict[str, Tensors], batch: Dict,
                              pos: Optional[torch.Tensor]) -> torch.Tensor:
        """Touched-row adagrad on the three id tables, in place; returns the
        number of rows the scatter budget dropped. On a mesh the batch, the
        masked positions and the gradients given are the global ones."""
        cfg = self.cfg
        d = cfg.embed_dim
        hist, hv = batch["history"], batch["history_valid"]
        tgt_feats = self._target_feats(batch, pos)
        tv = self._target_valid(hv)
        src = batch.get("sparse_scatter_src")
        dropped = torch.zeros((), dtype=torch.long, device=self.device)
        for name in SPARSE_TABLES:
            vocab = self._vocab[name]
            tgt_ids = tgt_feats[name]
            if tv is not None:
                tgt_ids = torch.where(tv, tgt_ids, vocab)
            # padded positions carry exactly-zero gradients: the sentinel
            # drops their writes
            ids = torch.cat([torch.where(hv, hist[name], vocab).reshape(-1),
                             tgt_ids.reshape(-1)])
            g = torch.cat([gdummies["hist"][name].reshape(-1, d),
                           gdummies["tgt"][name].reshape(-1, d)])
            if src is not None:
                n = ids.shape[0]
                ok = src < n
                safe = src.clamp_max(n - 1)
                ids = torch.where(ok, ids[safe], vocab)
                g = g[safe] * ok[:, None].to(g.dtype)
                dropped = torch.maximum(dropped, batch["sparse_overflow"])
            elif 0 < cfg.sparse_scatter_budget < ids.shape[0]:
                tgt_valid = torch.ones_like(tgt_ids, dtype=torch.bool) if tv is None else tv
                valid = torch.cat([hv.reshape(-1), tgt_valid.reshape(-1)])
                ids, g, dr = compact_valid_rows(ids, g, valid, cfg.sparse_scatter_budget, vocab)
                dropped = torch.maximum(dropped, dr)
            table = self.tables[name]
            self._update_rows(self._update, table, params[table], accums[table], ids, g,
                              cfg.sparse_embedding_lr)
        return dropped

    def _train_step(self, state: TrainState, batch: Dict,
                    generator: Optional[torch.Generator] = None,
                    mask_positions: Optional[torch.Tensor] = None):
        """One step on a ``_put_batch`` batch; ``generator`` (CPU) draws the
        masked positions (``mask_positions`` [B, M] gives them instead, for
        the global batch on a mesh) and the dropout seeds. Updates the
        state's tensors in place and returns (the state one step on,
        metrics as device tensors). With the recorder on
        (``utils/profiling``) the step is the span ``train_step`` over
        ``forward`` (holding the tower's ``compression`` and
        ``tower_blocks`` and the ``in_batch_loss``), ``backward``,
        ``optimizer`` and ``sparse_update``, and counts
        ``activation_bytes`` (what the backward holds), ``host_syncs``,
        each table's lookups and unique rows and, with sparse updates,
        ``sparse_dropped_rows``."""
        cfg = self.cfg
        params = state.params
        sparse = cfg.use_sparse_embedding_updates
        names = [n for n, t in params.items() if t.requires_grad]
        with span("train_step", step=state.step):
            pos = None
            if self.mode == "masked":
                b = batch["history_valid"].shape[0] * (1 if self.mesh is None
                                                       else self.mesh.shape["data"])
                pos = (self.draw_mask_positions(b, generator) if mask_positions is None
                       else torch.as_tensor(mask_positions).to(self.device, torch.long))
            with self._on_mesh(params):
                with span("forward"):
                    dummies = self._make_dummies(batch) if sparse else None
                    flat = [] if dummies is None else [dummies[g][k] for g in ("hist", "tgt")
                                                        for k in SPARSE_TABLES]
                    loss, metrics = functional_call(
                        self._apply, {f"tower.{k}": v for k, v in params.items()},
                        (self._loss, batch, dummies, generator,
                         None if pos is None else self._global_rows(pos)))
                count_allocated("activation_bytes")
                with span("backward"):
                    grads = torch.autograd.grad(loss, [params[n] for n in names] + flat,
                                                allow_unused=True)
                    gparams = {n: torch.zeros_like(params[n]) if g is None else g
                               for n, g in zip(names, grads)}
                    self._reduce_grads(gparams)
            with span("optimizer"):
                metrics["grad_norm"] = self._grad_norm(gparams)
                self.optimizer.step(params, gparams,
                                    state.opt_state[0] if sparse else state.opt_state)
            if sparse:
                with span("sparse_update"):
                    it = iter(grads[len(names):])
                    gd = {g: {k: next(it) for k in SPARSE_TABLES} for g in ("hist", "tgt")}
                    dropped = self._apply_sparse_updates(params, state.opt_state[1],
                                                         self._gather_batch(gd),
                                                         self._gather_batch(batch), pos)
                count("sparse_dropped_rows", dropped)
                if cfg.sparse_scatter_budget > 0:
                    metrics["sparse_dropped_rows"] = dropped
            metrics = self._reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                           ("loss", "in_batch_accuracy"))
        return state._replace(step=state.step + 1), metrics

    @torch.no_grad()
    def _eval_step(self, params: Tensors, batch: Dict) -> Dict[str, torch.Tensor]:
        """In-batch HR@K, NDCG@K and MRR: row i's true item is column i (on
        a mesh, over the global batch)."""

        def scores(tower):
            interests = self._gather_batch(tower(batch["history"], batch["history_valid"]))
            items = self._gather_batch(tower.item_embeddings(batch["target"]))
            return RetrievalTower.compute_scores(interests, items)

        with self._on_mesh(params):
            s = functional_call(self._apply, {f"tower.{k}": v for k, v in params.items()},
                                (scores,))
        b = s.shape[0]
        ks = tuple(k for k in (1, 5, 10, 50, 100) if k <= b)
        return retrieval_metric_suite(s, torch.arange(b, device=s.device), ks=ks)

    # -- loops ---------------------------------------------------------------
    def evaluate(self, state: TrainState, val_batches: Iterator[Dict]) -> Dict[str, float]:
        accum: Dict[str, list] = {}
        for batch in val_batches:
            for k, v in self._eval_step(state.params, self._put_batch(batch)).items():
                accum.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in accum.items()}

    def train(
        self,
        train_iter: Iterator[Dict],
        num_steps: int,
        val_fn=None,
        eval_every: int = 1000,
        log_every: int = 100,
        seed: int = 0,
        profile_dir: Optional[str] = None,
        profile_start: int = 10,
        profile_num_steps: int = 5,
    ) -> TrainState:
        """Train from ``init_retrieval_params(cfg, seed)`` (or the newest
        checkpoint of ``checkpoint_dir``) to step ``num_steps``; ``seed``
        also seeds the generator of masked positions and dropout. Logs every
        ``log_every`` steps into ``history["train"]`` (with ``steps_per_s``
        and ``examples_per_s``), evaluates ``val_fn()`` every ``eval_every``
        steps into ``history["val"]``, saves a checkpoint every
        ``eval_every`` steps and at the end. With ``profile_dir`` it writes a
        ``torch.profiler`` trace of steps [profile_start, profile_start +
        profile_num_steps) after the start step there."""
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
            if val_fn is not None and (i + 1) % eval_every == 0:
                vm = self.evaluate(state, val_fn())
                self.logger.log("val", i + 1, vm)
                self.history["val"].append({"step": i + 1, **vm})
                t0 = time.time()
            if (i + 1) % eval_every == 0:
                self._save(state, generator)
            if i + 1 < num_steps:
                batch = next(train_iter)
        prof.close()
        self._save(state, generator)
        if self.ckpt is not None:
            self.ckpt.wait()  # the saves run in a thread; the last one is on disk
        return state

    def _save(self, state: TrainState, generator: torch.Generator) -> None:
        self._save_ckpt(state.step, state.params, state.opt_state, generator.get_state())
