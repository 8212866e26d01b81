"""The OneTrans replica track's training held against the JAX trainer over a
whole epoch on the CPU, not 1-3 steps: the track's config (replica v2 at the
JAX quality board's weights, adam at a constant lr, clip 90, rowwise sparse
adagrad at 0.02, no warm-up) cut to 2 layers at d 32 with 16-wide
embeddings, 12,000 impressions at batch 64 (159 steps), float32; and at the
track's S depth (6 layers, pyramid 0.5 .. 0.03, 2 heads, 12 NS tokens) at d
64 over the full scale's long behaviour streams, 4,000 impressions (52
steps). From the same converted state on the same batches, every step's
loss and gradient norm and the epoch's validation AUCs agree with JAX's:
the port follows the JAX trainer's trajectory through an epoch, so a
learning curve that departs from the TPU's on the card is not the port's
arithmetic at float32. (Its initial draw is another matter: the port's own
initializers are held to flax's scales in ``test_torch_init.py``. The same
epochs in bf16, as the card trains, are ``test_torch_quality_onetrans_bf16.py``'s:
``_setup`` and ``_epoch`` take ``mixed_precision``.)"""

import itertools

import jax
import numpy as np
import torch

import quality_torch as q
from recommend_tpu.config import get_config as jget_config
from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import accums_from_flax, params_from_flax
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_torch_quality_onetrans import jax_base

torch.set_num_threads(1)

TINY = dict(embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, pyramid_ratios=(0.5, 0.25),
            feature_embed_dim=16, seq_item_feature_dim=16, batch_size=64, lr_warmup_steps=0)
# the track's S geometry but its widths: 6 layers, the pyramid, 2 heads
S_NARROW = dict(embed_dim=64, ffn_dim=256, feature_embed_dim=32, seq_item_feature_dim=32,
                batch_size=64, lr_warmup_steps=0)
BOARD = dict(match=4.0, order=1.4, cross=1.8, alpha=-3.0)


def _setup(monkeypatch, widths, num_impressions, stream_kw, n_steps, mixed_precision=False):
    """Both trainers at the same state, JAX's init converted: (the JAX
    trainer and state, the port's, the epoch's batches, the validation
    split, the JAX config). ``mixed_precision`` computes in bf16 on both
    sides (JAX's CPU backend needs ``tests/jax_bf16_shim.py`` for it)."""
    jcfg = jget_config("ranking_base", **{**jax_base("small", "S", False), **widths,
                                          "use_mixed_precision": mixed_precision})
    tcfg = RankingConfig.from_dict(jcfg.to_dict())
    monkeypatch.setattr(q, "onetrans_sizes", lambda scale: dict(
        num_users=150, num_items=400, num_impressions=num_impressions, stream_kw=stream_kw,
        batch=64))
    tr, val, _, _ = q.make_replica(tcfg, "small", 0, "v2", 0.05, BOARD)
    batches = list(ranking_batches(tr, jcfg, 64, seed=0, num_epochs=1))
    assert len(batches) == tr.num_samples // 64 == n_steps

    jt = JaxTrainer(jcfg)
    js = jt.init_state(jax.random.key(0), batches[0])
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    tt = RankingTrainer(tcfg, device="cpu")
    ts = tt.init_state(params_from_flax(tree, tcfg), accums=accums_from_flax(
        jax.tree_util.tree_map(np.asarray, js.opt_state[1]), tcfg))
    return jt, js, tt, ts, batches, val, jcfg


def _epoch(monkeypatch, widths, num_impressions, stream_kw, n_steps, mixed_precision=False):
    """Both trainers through one epoch from JAX's init: the (port, JAX) loss
    and gradient norm of every step, and both validation reports."""
    jt, js, tt, ts, batches, val, jcfg = _setup(monkeypatch, widths, num_impressions,
                                                stream_kw, n_steps, mixed_precision)
    losses, norms = [], []
    for batch in batches:
        js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
        ts, tm = tt._train_step(ts, tt._put_batch(batch))
        losses.append((float(tm["loss"]), float(jm["loss"])))
        norms.append((float(tm["grad_norm"]), float(jm["grad_norm"])))

    def val_batches():
        return itertools.islice(ranking_batches(val, jcfg, 64, seed=1, num_epochs=1), 100)

    reports = tt.evaluate(ts, val_batches()), jt.evaluate(js, val_batches())
    return np.asarray(losses), np.asarray(norms), reports


def _hold(losses, norms, reports, learns=True):
    # the trajectories agree step for step (measured: 6.6e-7 and 4.5e-6
    # relative at most at 2 layers; float32 sums in another order drift by ulps)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
    np.testing.assert_allclose(norms[:, 0], norms[:, 1], rtol=1e-4)
    if learns:  # at 2 layers an epoch lowers the loss
        assert losses[-20:, 0].mean() < losses[:20, 0].mean()
    tv, jv = reports
    for k in ("ctr_auc", "cvr_auc"):
        assert abs(tv[k] - jv[k]) < 1e-5, (k, tv[k], jv[k])


def test_an_epoch_of_the_track_follows_the_jax_trainer(monkeypatch):
    _hold(*_epoch(monkeypatch, TINY, 12_000, {}, 159))


def test_an_epoch_at_the_s_depth_follows_the_jax_trainer(monkeypatch):
    # too few steps at this depth to lower the loss, in JAX as in the port
    _hold(*_epoch(monkeypatch, S_NARROW, 4_000, q.onetrans_sizes("full")["stream_kw"], 52),
          learns=False)
