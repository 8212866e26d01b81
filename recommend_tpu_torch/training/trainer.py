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
The step, the state, resume, checkpoints and the loop are
``training/base.py``'s.

``checkpoint_dir`` (``training/checkpoint.py``): ``init_state`` resumes from
the newest checkpoint there (parameters, adamw moments and count,
accumulators, the step and the generator's state); ``train`` saves every
``eval_every`` steps and at the end. ``init_state`` also takes a JAX
trainer's converted state (``convert.retrieval_params_from_flax``,
``convert.retrieval_opt_state_from_flax``), so a JAX run continues here.

The trainer runs on CUDA unless given ``device="cpu"``; with no device given
and no CUDA available it raises. With a ``mesh`` (``parallel.make_mesh``) it
runs on the mesh's device, one process per rank, every rank given the same
host batches (``training/base.py``): a step computes what one device
computes on the whole batch. The in-batch losses score each rank's rows
against every rank's candidates (``models/losses.py``), the masked positions
are drawn for the global batch and sliced, and the host compaction is
skipped: the budget compacts the global rows on the device, as JAX's mesh
path does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.convert import init_retrieval_params
from recommend_tpu_torch.models.losses import in_batch_softmax_loss, seq2seq_in_batch_loss
from recommend_tpu_torch.models.retrieval import RetrievalTower
from recommend_tpu_torch.ops.embedding import SPARSE_TABLES
from recommend_tpu_torch.ops.sparse_embed import make_dummy
from recommend_tpu_torch.training.base import Tensors, TrainerBase, TrainState
from recommend_tpu_torch.training.metrics import retrieval_metric_suite
from recommend_tpu_torch.training.optimizer import make_retrieval_optimizer
from recommend_tpu_torch.utils.profiling import count


class _Apply(nn.Module):
    """Calls ``fn(tower, *args)``: one ``functional_call`` runs whichever
    tower methods a loss needs on the state's tensors."""

    def __init__(self, tower: RetrievalTower):
        super().__init__()
        self.tower = tower

    def forward(self, fn, *args):
        return fn(self.tower, *args)


class RetrievalTrainer(TrainerBase):
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
        self.mode = mode
        with torch.device("meta"):
            model = RetrievalTower(cfg)
        super().__init__(cfg, model, mesh, device, checkpoint_dir, log_dir, max_to_keep)
        self._apply = _Apply(self.model)
        self.tables = [f"embed.tables.{n}.weight" for n in SPARSE_TABLES]
        self.optimizer = make_retrieval_optimizer(cfg, total_steps, self.tables)
        # the raw (uncompressed) tail: the seq2seq and masked positions
        last = cfg.schedule_specs()[-1]
        self.tail_r = last.num_tokens if last.group_size == 1 else 0
        self.num_mask = max(1, min(8, self.tail_r - 1))
        if mode != "single":
            assert self.tail_r > 1, f"{mode} mode needs a raw (group_size=1) tail segment"
        self._vocab = {"video_id": cfg.video_vocab_size, "category": cfg.category_vocab_size,
                       "tag": cfg.tag_vocab_size}

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
        dev = self.device
        batch = self._shard_batch(batch)

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

        def feats(group):
            return {k: put(v, torch.float32 if k == "duration" else torch.long)
                    for k, v in group.items()}

        def valid():
            hv = np.asarray(batch["history_valid"])
            tv = self._target_valid(hv)
            if tv is None:
                tv = np.ones((hv.shape[0], self.num_mask if self.mode == "masked" else 1), bool)
            return np.concatenate([hv.reshape(-1), tv.reshape(-1)])

        out = {"history": feats(batch["history"]), "target": feats(batch["target"]),
               "history_valid": put(batch["history_valid"], torch.bool)}
        for k in ("target_popularity", "history_popularity"):
            if k in batch:
                out[k] = put(batch[k], torch.float32)
        out.update(self._host_compaction(valid))
        return out

    def _fresh_params(self, seed: int) -> Tensors:
        return init_retrieval_params(self.cfg, seed=seed, device=self.device)

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
    def _step_draws(self, batch: Dict, generator: Optional[torch.Generator],
                    mask_positions: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """masked: the step's [B, M] positions, for the global batch on a
        mesh, drawn from ``generator`` unless ``mask_positions`` gives
        them."""
        if self.mode != "masked":
            return None
        if mask_positions is not None:
            return torch.as_tensor(mask_positions).to(self.device, torch.long)
        b = batch["history_valid"].shape[0] * (1 if self.mesh is None
                                               else self.mesh.shape["data"])
        return self.draw_mask_positions(b, generator)

    def _forward(self, params: Tensors, batch: Dict, dummies: Dict[str, Tensors], generator,
                 pos: Optional[torch.Tensor]):
        """(loss, metrics) of the mode's in-batch loss: the forward holds the
        tower's spans ``compression`` and ``tower_blocks`` and the loss's
        ``in_batch_loss``."""
        return functional_call(
            self._apply, {f"tower.{k}": v for k, v in params.items()},
            (self._loss, batch, dummies or None, generator,
             None if pos is None else self._global_rows(pos)))

    def _dropped_rows(self, metrics: Tensors, dropped: torch.Tensor) -> None:
        """Counted under ``sparse_dropped_rows`` too (0 with no budget)."""
        count("sparse_dropped_rows", dropped)
        super()._dropped_rows(metrics, dropped)

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
        dropped = torch.zeros((), dtype=torch.long, device=self.device)
        for name, table in zip(SPARSE_TABLES, self.tables):
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
            ids, g, cut = self._compact(ids, g, batch, vocab, lambda: torch.cat(
                [hv.reshape(-1), (torch.ones_like(tgt_ids, dtype=torch.bool) if tv is None
                                  else tv).reshape(-1)]))
            if cut is not None:
                dropped = torch.maximum(dropped, cut)
            self._update_rows(table, params[table], accums[table], ids, g,
                              cfg.sparse_embedding_lr)
        return dropped

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
