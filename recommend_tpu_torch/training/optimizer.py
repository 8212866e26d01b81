"""The optimizers and their learning-rate schedules, written by hand with
optax's semantics (the port's counterpart of the JAX package's
``training/optimizer.py``).

``make_ranking_optimizer`` is optax's
``chain(clip_by_global_norm(clip), multi_transform({"dense": d, "sparse": s}))``
over a dict of named tensors: the id tables (``sparse_names``) take adagrad
or sgd, the rest ``rmsprop`` with a momentum trace, ``adam`` or ``adamw``
(weight decay masked to tensors of two or more dimensions). Where they
differ from ``torch.optim``, optax's choices hold: rmsprop decays at 0.9
with eps inside the square root, then scales by -lr, then adds the momentum
trace; the clip divides by the bare global norm (no 1e-6).

``make_retrieval_optimizer`` is the retrieval tower's ``optax.adamw`` on the
warmup-cosine schedule, with the config's b1/b2, eps 1e-8 outside the square
root and no gradient clip; weight decay applies to every tensor it updates.
With sparse embedding updates the id tables are left to the touched-row path
(optax's ``set_to_zero`` there): the optimizer keeps no state for them and
never writes them.

``RankingOptimizer.step`` and ``RetrievalOptimizer.step`` update parameters
and state IN PLACE.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig

Schedule = Union[float, Callable[[int], float]]
Tensors = Dict[str, torch.Tensor]


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           final_scale: float = 0.01) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule from 0: linear warmup to
    ``peak_lr`` over ``warmup_steps``, then cosine decay to
    ``peak_lr * final_scale`` at ``max(total_steps, warmup_steps + 1)``."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if peak_lr == 0.0 else final_scale

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def sparse_lr_schedule(cfg: RankingConfig) -> Schedule:
    """Per-step sparse (id-table) learning rate: a linear ramp from
    ``sparse_lr_init`` to ``sparse_lr`` over ``sparse_lr_warmup_steps``, then
    constant. The plain float when no ramp is configured."""
    n = cfg.sparse_lr_warmup_steps
    if n <= 0:
        return cfg.sparse_lr

    def schedule(step: int) -> float:
        frac = float(np.minimum(np.float32(step) / np.float32(n), np.float32(1.0)))
        return cfg.sparse_lr_init + (cfg.sparse_lr - cfg.sparse_lr_init) * frac

    return schedule


def _lr_at(lr: Schedule, count: int) -> float:
    return lr(count) if callable(lr) else lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class RankingOptimizer:
    """Global-norm clip, then the dense rule on every tensor not in
    ``sparse_names`` and the sparse rule on those."""

    def __init__(self, cfg: RankingConfig, total_steps: int = 0,
                 sparse_names: Iterable[str] = ()):
        if cfg.dense_lr_schedule == "cosine":
            if total_steps <= 0:
                raise ValueError("the cosine schedule needs total_steps > 0")
            self.dense_lr: Schedule = warmup_cosine_schedule(
                cfg.dense_lr, cfg.lr_warmup_steps, total_steps)
        elif cfg.dense_lr_schedule == "constant":
            self.dense_lr = cfg.dense_lr
        else:
            raise ValueError(f"unknown dense_lr_schedule {cfg.dense_lr_schedule!r}")
        if cfg.dense_optimizer not in ("rmsprop", "adam", "adamw"):
            raise ValueError(f"unknown dense_optimizer {cfg.dense_optimizer!r}")
        if cfg.sparse_optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown sparse_optimizer {cfg.sparse_optimizer!r}")
        self.cfg = cfg
        self.sparse_names = frozenset(sparse_names)
        self.sparse_lr = sparse_lr_schedule(cfg)

    def init(self, params: Tensors) -> dict:
        zeros = lambda names: {n: torch.zeros_like(params[n]) for n in names}
        dense = [n for n in params if n not in self.sparse_names]
        sparse = [n for n in params if n in self.sparse_names]
        if self.cfg.dense_optimizer == "rmsprop":
            dstate = {"nu": zeros(dense), "trace": zeros(dense)}
        else:
            dstate = {"mu": zeros(dense), "nu": zeros(dense)}
        sstate = {}
        if self.cfg.sparse_optimizer == "adagrad":
            sstate = {"sum_of_squares": {n: torch.full_like(params[n], 0.1)
                                         for n in sparse}}
        return {"count": 0, "dense": dstate, "sparse": sstate}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: dict,
             norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place; returns the
        global norm of ``grads`` before clipping (``norm`` gives it: the
        full tensors' when ``grads`` holds a rank's blocks)."""
        cfg = self.cfg
        names = list(grads)
        if norm is None:
            norm = global_norm(grads[n] for n in names)
        clip = cfg.gradient_clip_norm
        trigger = norm < clip
        count = state["count"]
        dense_lr = _lr_at(self.dense_lr, count)
        sparse_lr = _lr_at(self.sparse_lr, count)
        ds, ss = state["dense"], state["sparse"]
        for n in names:
            p = params[n]
            g = torch.where(trigger, grads[n], grads[n] / norm * clip)
            if n in self.sparse_names:
                if cfg.sparse_optimizer == "adagrad":
                    sos = ss["sum_of_squares"][n]
                    sos.add_(g.square())
                    u = torch.where(sos > 0, torch.rsqrt(sos + 1e-7), 0.0) * g
                else:
                    u = g
                p.add_(u * -sparse_lr)
            elif cfg.dense_optimizer == "rmsprop":
                nu = ds["nu"][n]
                nu.copy_(g.square() * (1 - 0.9) + nu * 0.9)
                u = torch.rsqrt(nu + 1e-8) * g * -dense_lr
                trace = ds["trace"][n]
                trace.copy_(u + trace * cfg.dense_momentum)
                p.add_(trace)
            else:
                mu, nu = ds["mu"][n], ds["nu"][n]
                mu.copy_(g * (1 - 0.9) + mu * 0.9)
                nu.copy_(g.square() * (1 - 0.999) + nu * 0.999)
                mu_hat = mu / _bias_correction(0.9, count + 1)
                nu_hat = nu / _bias_correction(0.999, count + 1)
                u = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
                if cfg.dense_optimizer == "adamw" and p.ndim >= 2:
                    u = u + cfg.dense_weight_decay * p
                p.add_(u * -dense_lr)
        state["count"] = count + 1
        return norm


def make_ranking_optimizer(cfg: RankingConfig, total_steps: int = 0,
                           sparse_names: Iterable[str] = ()) -> RankingOptimizer:
    return RankingOptimizer(cfg, total_steps, sparse_names)


class RetrievalOptimizer:
    """``optax.adamw(warmup_cosine, b1, b2, eps=1e-8, weight_decay)`` over a
    dict of named tensors; the names in ``frozen`` are skipped."""

    def __init__(self, cfg: RetrievalConfig, total_steps: int = 100_000,
                 frozen: Iterable[str] = ()):
        self.cfg = cfg
        self.lr = warmup_cosine_schedule(cfg.learning_rate, cfg.warmup_steps, total_steps)
        self.frozen = frozenset(frozen)

    def init(self, params: Tensors) -> dict:
        names = [n for n in params if n not in self.frozen]
        return {"count": 0, "mu": {n: torch.zeros_like(params[n]) for n in names},
                "nu": {n: torch.zeros_like(params[n]) for n in names}}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: dict) -> None:
        """One update of ``params`` and ``state`` in place, from ``grads``
        (frozen names in it are ignored)."""
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        count = state["count"]
        lr = self.lr(count)
        c1, c2 = _bias_correction(b1, count + 1), _bias_correction(b2, count + 1)
        for n, g in grads.items():
            if n in self.frozen:
                continue
            p, mu, nu = params[n], state["mu"][n], state["nu"][n]
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_(g.square() * (1 - b2) + nu * b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + 1e-8) + cfg.weight_decay * p
            p.add_(u * -lr)
        state["count"] = count + 1


def make_retrieval_optimizer(cfg: RetrievalConfig, total_steps: int = 100_000,
                             table_names: Iterable[str] = ()) -> RetrievalOptimizer:
    """The retrieval trainer's dense optimizer. ``table_names``: the id
    tables' parameter names, frozen when ``use_sparse_embedding_updates``
    is on."""
    return RetrievalOptimizer(
        cfg, total_steps, table_names if cfg.use_sparse_embedding_updates else ())
