"""Ranking trainer: the port of the JAX package's
``training/ranking_trainer.RankingTrainer``.

A multi-task BCE loop over ``RankingModel``: global-norm clip and the dense
optimizer (``training/optimizer.py``), touched-row adagrad on the id tables
when ``use_sparse_embedding_updates`` is on (``ops/sparse_embed.py``), dense
adagrad or sgd on them otherwise; streaming AUC in ``evaluate``; best-params
tracking and early stopping in ``train``. The step, the state, resume,
checkpoints and the loop are ``training/base.py``'s.

With sparse updates the tables stay outside autograd: zeros "dummies", one
row per lookup, receive the per-lookup gradients.

``model=`` takes any module with ``RankingModel``'s forward signature whose
id tables carry ``RankingModel``'s names under ``tokenizer.`` (the DCNv2+DIN
baseline, ``models/din.py``). ``debug_metrics`` adds training-health scalars
to each step's metrics.

``checkpoint_dir`` (``training/checkpoint.py``): ``init_state`` resumes from
the newest checkpoint there (parameters, optimizer state with its count,
the step, and the dropout generator's state, which JAX needs not keep: it
folds the step into a fixed key); ``train`` saves at every better
evaluation and at the end. ``profile_dir`` traces a window of steps with
``torch.profiler`` (``utils/profiling.py``), with the step's spans on.

The trainer runs on CUDA unless given ``device="cpu"``; with no device
given and no CUDA available it raises. With a ``mesh``
(``parallel.make_mesh``) it runs on the mesh's device, one process per
rank, every rank given the same host batches (``training/base.py``): a
step computes what one device computes on the whole batch. The loss of each
rank is its share of the global batch's mean, the host compaction is
skipped, and ``evaluate`` scores the global batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import init_params, table_param_names
from recommend_tpu_torch.models.losses import multi_task_bce_loss
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.ops.sparse_embed import make_dummy
from recommend_tpu_torch.training.base import Tensors, TrainerBase, TrainState
from recommend_tpu_torch.training.metrics import streaming_auc
from recommend_tpu_torch.training.optimizer import make_ranking_optimizer, sparse_lr_schedule


class RankingTrainer(TrainerBase):
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
        if model is None:
            with torch.device("meta"):
                model = RankingModel(cfg)
        super().__init__(cfg, model, mesh, device, checkpoint_dir, log_dir, max_to_keep)
        self.debug_metrics = debug_metrics
        self.tables = table_param_names(cfg)
        self._ns_tables = dict(zip(cfg.non_seq_features, self.tables))  # feature -> table
        self._item_table = self.tables[-1] if cfg.sequence_features else None
        self.optimizer = make_ranking_optimizer(cfg, total_steps, self.tables)
        self._auc = streaming_auc(device=self.device)
        self._sparse_lr = sparse_lr_schedule(cfg)

    # -- batches and state --------------------------------------------------
    def _seq_names_of(self, batch) -> list:
        """The sequence-feature row layout shared by the dummies, the sparse
        update and the host-side compaction indices."""
        return [sf for sf in self.cfg.sequence_features if sf in batch["sequences"]]

    def _put_batch(self, batch: Dict) -> Dict:
        """A numpy batch -> tensors on the trainer's device (ids int64, the
        semantic features' [B, dim] vectors float32, validity bool, labels
        float32), with the sparse-scatter compaction indices precomputed on
        the host when a budget is set (the sequence rows' validity, feature
        by feature). On a mesh: this rank's block, not compacted."""
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
        if batch.get("sequences"):
            out.update(self._host_compaction(lambda: np.concatenate(
                [np.asarray(batch["seq_valid"][sf]).reshape(-1)
                 for sf in self._seq_names_of(batch)])))
        return out

    def init_state(self, params: Optional[Tensors] = None, seed: int = 0,
                   accums: Optional[Tensors] = None,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """``TrainerBase.init_state`` from a zero optimizer state; ``params``
        e.g. from ``convert.params_from_flax``."""
        return super().init_state(params, seed, None, accums, generator)

    def _fresh_params(self, seed: int) -> Tensors:
        return init_params(self.cfg, seed=seed, device=self.device, model=self.model)

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

    def _forward(self, params: Tensors, batch: Dict, dummies: Tensors, generator, draws):
        """(loss, metrics) of the model with dropout; with ``debug_metrics``
        the training-health scalars join the metrics."""
        logits = self._logits(params, batch, deterministic=False,
                              dummies=dummies or None, generator=generator)
        loss, metrics = multi_task_bce_loss(logits, batch["labels"])
        if self.mesh is not None:  # this rank's share of the global mean
            share = 1.0 / self.mesh.shape["data"]
            loss = loss * share
            metrics = {k: v * share for k, v in metrics.items()}
        if self.debug_metrics:
            self._add_debug_metrics(metrics, logits, params)
        return loss, metrics

    def _dense_update(self, params: Tensors, grads: Tensors, opt_state: dict) -> torch.Tensor:
        """The clip and the dense rule; the norm of the full tensors."""
        return self.optimizer.step(params, grads, opt_state, self._grad_norm(grads))

    def _sparse_update(self, params: Tensors, accums: Tensors, gdummies: Tensors,
                       batch: Dict, step: int, draws) -> torch.Tensor:
        """At the step's sparse rate; on a mesh only what the update reads
        is gathered."""
        if self.mesh is not None:
            batch = {k: batch[k] for k in ("non_seq", "sequences", "seq_valid")}
        lr = self._sparse_lr(step) if callable(self._sparse_lr) else self._sparse_lr
        return self._apply_sparse_updates(params, accums, gdummies, self._gather_batch(batch),
                                          lr)

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
            ids, g, cut = self._compact(ids, g, batch, item_vocab, lambda: torch.cat(
                [batch["seq_valid"][sf].reshape(-1) for sf in seq_names]))
            if cut is not None:
                dropped = cut
            name = self._item_table
            self._update_rows(name, params[name], accums[name], ids, g, lr)
        for f, name in self._ns_tables.items():
            self._update_rows(name, params[name], accums[name], batch["non_seq"][f],
                              gdummies[f"ns_{f}"], lr)
        return dropped

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
        self.best_params = None
        self.best_val_step = None
        self.best_val_metrics = None
        best = {"val": -float("inf"), "bad_evals": 0}

        def at_eval(state: TrainState, generator, step: int, vm: Optional[dict]) -> bool:
            if vm is None:
                return False
            primary = vm.get(f"{self.cfg.tasks[0]}_auc", -vm.get("loss", 0.0))
            if primary > best["val"]:
                best["val"], best["bad_evals"] = primary, 0
                if track_best_params:
                    # copies: the step updates the state's tensors in place
                    self.best_params = {k: v.detach().clone() for k, v in state.params.items()}
                    self.best_val_step = step
                    self.best_val_metrics = dict(vm)
                self._save(state, generator)
                return False
            best["bad_evals"] += 1
            return bool(early_stop_patience) and best["bad_evals"] >= early_stop_patience

        return self._train(train_iter, num_steps, val_fn, eval_every, log_every, seed,
                           profile_dir, profile_start, profile_num_steps, at_eval)
