"""The OneTrans replica track's training held against the JAX trainer in
bf16, as the card trains it (``use_mixed_precision``), on the CPU.

JAX's CPU backend runs its bf16 step only through ``tests/jax_bf16_shim.py``
(bf16 products and sums accumulated in f32, the output rounded to the op's
dtype, as on the card and the TPU). Under it, from one converted JAX init:

- the first step's gradients at the track's S depth and pyramid
  (``S_NARROW``, and in bf16 also at the S widths, ``S_FULL``): every dense tensor and every per-lookup (dummy) gradient
  of ``torch.autograd.grad`` in the port's step against ``jax.grad`` of the
  JAX trainer's loss, as the norm of the difference over the norm of JAX's
  (float32 as a control);
- a whole bf16 epoch, ``test_torch_quality_onetrans_steps._epoch`` at
  ``mixed_precision=True``: 52 steps at ``S_NARROW`` and 159 at ``TINY``,
  every step's loss and grad norm and the validation AUCs.

Tolerances, each the largest reading on this CPU widened with room (bf16
trajectories drift apart by rounding, and XLA may split a sum otherwise
at another thread count):

=====================================  ========  =========
quantity                               reading   held at
=====================================  ========  =========
first step, dense (bf16)               2.1e-2    5e-2
  at the full S widths                 2.5e-2    5e-2
first step, dummies (bf16)             1.6e-2    4e-2
first step, grad norm (bf16)           1.1e-3    5e-3
first step, dense / dummies (f32)      3.1e-6    1e-4
first step, grad norm (f32)            1e-7      1e-5
epoch loss, each step (rtol)           1.7e-3    6e-3
epoch grad norm, each step (rtol)      2.5e-2    7e-2
epoch validation AUCs (atol)           2.8e-3    1e-2
=====================================  ========  =========

The largest dense gap is on ``blocks.0.k_s.bias``, whose true gradient is 0
(softmax shift): its gradient is rounding on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.models.losses import multi_task_bce_loss as jax_bce
from recommend_tpu_torch.convert import params_from_flax, table_param_names
from tests import test_torch_quality_onetrans_steps as steps
from tests.jax_bf16_shim import bf16_as_on_the_card

torch.set_num_threads(1)

S_STREAMS = steps.q.onetrans_sizes("full")["stream_kw"]
# the track's S model at its own widths (d 256, ffn 1024, 128-wide
# embeddings), at batch 64
S_FULL = dict(batch_size=64, lr_warmup_steps=0)
# (dense, dummies, grad norm) relative tolerances of the first step
FIRST_STEP_TOL = {False: (1e-4, 1e-4, 1e-5), True: (5e-2, 4e-2, 5e-3)}
EPOCH_LOSS_RTOL, EPOCH_NORM_RTOL, EPOCH_AUC_ATOL = 6e-3, 7e-2, 1e-2


@pytest.fixture
def shim():
    with bf16_as_on_the_card():
        yield


def _jax_first_grads(jt, js, batch, cfg):
    """``jax.grad`` of the JAX trainer's loss at its state: (the dense
    gradients as a flax tree, the dummies' gradients by name)."""
    jb = jt._put_batch(batch)
    dense, tables = jt._split_tables(js.params)
    dummies = {f"ns_{f}": jnp.zeros(jb["non_seq"][f].shape + (cfg.feature_embed_dim,))
               for f in cfg.non_seq_features}
    dummies.update({f"seq_{sf}": jnp.zeros(jb["sequences"][sf].shape
                                           + (cfg.seq_item_feature_dim,))
                    for sf in cfg.sequence_features if sf in jb["sequences"]})

    def loss(dense, dummies):
        logits = jt.model.apply(jt._merge_tables(dense, tables), jb["non_seq"], jb["sequences"],
                                jb["seq_valid"], deterministic=False, dummies=dummies,
                                rngs={"dropout": jax.random.key(0)})
        return jax_bce(logits, jb["labels"])[0]

    gdense, gdummies = jax.jit(jax.grad(loss, argnums=(0, 1)))(dense, dummies)
    zeros = {k: jnp.zeros_like(v) for k, v in tables.items()}
    return jt._merge_tables(gdense, zeros), gdummies


def _port_first_grads(tt, ts, batch):
    """The gradients the port's first step hands its optimizers: (dense by
    parameter name, dummies by name), and the step's metrics."""
    seen = {}
    dense_step, sparse_step = tt.optimizer.step, tt._apply_sparse_updates

    def dense(params, grads, *args):
        seen["dense"] = {n: g.detach().clone() for n, g in grads.items()}
        return dense_step(params, grads, *args)

    def sparse(params, accums, grads, *args):
        seen["dummies"] = {n: g.detach().clone() for n, g in grads.items()}
        return sparse_step(params, accums, grads, *args)

    tt.optimizer.step, tt._apply_sparse_updates = dense, sparse
    _, metrics = tt._train_step(ts, tt._put_batch(batch))
    return seen["dense"], seen["dummies"], metrics


def _rel(got, ref):
    """|got - ref| / |ref|; where JAX's gradient is exactly 0 (the S keys and
    values of the top blocks, which no kept query reads), 0 only if the
    port's is exactly 0 too."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    gap, scale = np.linalg.norm(got - ref), np.linalg.norm(ref)
    return gap / scale if scale > 0 else (0.0 if gap == 0 else np.inf)


@pytest.mark.parametrize("widths,mixed_precision", [
    (steps.S_NARROW, False), (steps.S_NARROW, True), (S_FULL, True)],
    ids=["f32", "bf16", "bf16-full-width"])
def test_the_first_steps_gradients_follow_jax(monkeypatch, shim, widths, mixed_precision):
    jt, js, tt, ts, batches, _, jcfg = steps._setup(monkeypatch, widths, 4_000, S_STREAMS, 52,
                                                    mixed_precision)
    jtree, jdummies = _jax_first_grads(jt, js, batches[0], jcfg)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jtree), tt.cfg)
    dense, dummies, metrics = _port_first_grads(tt, ts, batches[0])
    tables = set(table_param_names(tt.cfg))
    names = [n for n in dense if n not in tables and not torch.isnan(ref[n]).any()]
    assert len(names) == 122 and len(dummies) == len(jdummies) == 14
    dense_tol, dummy_tol, norm_tol = FIRST_STEP_TOL[mixed_precision]
    dense_gap = {n: _rel(dense[n], ref[n]) for n in names}
    dummy_gap = {n: _rel(dummies[n], jdummies[n]) for n in jdummies}
    worst = max(dense_gap, key=dense_gap.get)
    assert dense_gap[worst] <= dense_tol, (worst, dense_gap[worst])
    worst = max(dummy_gap, key=dummy_gap.get)
    assert dummy_gap[worst] <= dummy_tol, (worst, dummy_gap[worst])
    jnorm = np.sqrt(sum(np.square(np.asarray(ref[n], np.float64)).sum() for n in names))
    np.testing.assert_allclose(float(metrics["grad_norm"]), jnorm, rtol=norm_tol)


def _hold_bf16(losses, norms, reports, learns=True):
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=EPOCH_LOSS_RTOL)
    np.testing.assert_allclose(norms[:, 0], norms[:, 1], rtol=EPOCH_NORM_RTOL)
    if learns:  # at 2 layers an epoch lowers the loss, in bf16 too
        assert losses[-20:, 0].mean() < losses[:20, 0].mean()
    tv, jv = reports
    for k in ("ctr_auc", "cvr_auc"):
        assert abs(tv[k] - jv[k]) < EPOCH_AUC_ATOL, (k, tv[k], jv[k])


def test_a_bf16_epoch_of_the_track_follows_the_jax_trainer(monkeypatch, shim):
    _hold_bf16(*steps._epoch(monkeypatch, steps.TINY, 12_000, {}, 159, mixed_precision=True))


def test_a_bf16_epoch_at_the_s_depth_follows_the_jax_trainer(monkeypatch, shim):
    _hold_bf16(*steps._epoch(monkeypatch, steps.S_NARROW, 4_000, S_STREAMS, 52,
                             mixed_precision=True), learns=False)


def test_the_shim_sums_in_f32_and_is_gone_after_use():
    """A bias's gradient is a bf16 sum over the batch: XLA's CPU backend
    adds it up in bf16, the shim in f32 (then rounds it to bf16). Outside
    the block JAX compiles what it compiled before the block, bit for bit."""
    h = jnp.asarray(np.random.default_rng(0).normal(size=(512, 64)), jnp.bfloat16)

    def loss(bias):
        return jnp.square(h + bias.astype(jnp.bfloat16)).astype(jnp.float32).sum()

    exact = 2 * np.asarray(h, np.float64).sum(0)
    grad = jax.grad(loss)
    before = np.asarray(jax.jit(grad)(jnp.zeros(64)))
    with bf16_as_on_the_card():
        inside = np.asarray(jax.jit(grad)(jnp.zeros(64)))
    after = np.asarray(jax.jit(grad)(jnp.zeros(64)))
    # the shim's error is the output's bf16 rounding alone (0.24 here against 0.96)
    assert np.abs(inside - exact).max() < 0.5 * np.abs(before - exact).max()
    np.testing.assert_array_equal(after, before)
