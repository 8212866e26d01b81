"""The port's training slice held against the JAX package, on the CPU.

Data, sparse embedding updates, the dense optimizer, the loss, the streaming
AUC, dropout and remat, and whole ``RankingTrainer`` steps: the same numpy
inputs go through the JAX function and its port at float32. Tolerances are
stated beside each comparison: exact where the arithmetic is the same
elementwise float32 sequence, 1e-6 where sums run in another order, and
atol 1e-5 / rtol 1e-4 for trainer state after optimizer steps (rmsprop
divides by sqrt(nu), so last-digit gradient differences reach the update).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _tiny_cfg
from recommend_tpu.data import pipeline as jpipeline
from recommend_tpu.data import synthetic as jsynthetic
from recommend_tpu.models.losses import multi_task_bce_loss as j_bce
from recommend_tpu.ops import sparse_embed as jsparse
from recommend_tpu.training import metrics as jmetrics
from recommend_tpu.training import optimizer as joptimizer
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.convert import accums_from_flax, params_from_flax
from recommend_tpu_torch.data import pipeline as tpipeline
from recommend_tpu_torch.data import synthetic as tsynthetic
from recommend_tpu_torch.models.losses import multi_task_bce_loss as t_bce
from recommend_tpu_torch.ops import flash_attention as tfa
from recommend_tpu_torch.ops import sparse_embed as tsparse
from recommend_tpu_torch.training import metrics as tmetrics
from recommend_tpu_torch.training import optimizer as toptimizer
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_torch_ranking import port_config

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_ranking_data_and_batches_match_jax():
    """Same arrays from the same seed, and ranking_batches batch for batch
    (two epochs, a shard of two), exactly."""
    cfg = _tiny_cfg()
    jd = jsynthetic.make_ranking_data(cfg, num_samples=40, max_seq_per_feature=7, seed=3)
    td = tsynthetic.make_ranking_data(port_config(cfg), num_samples=40,
                                      max_seq_per_feature=7, seed=3)
    for group in ("non_seq", "sequences", "seq_lengths", "labels"):
        j, t = getattr(jd, group), getattr(td, group)
        assert list(j) == list(t)
        for k in j:
            np.testing.assert_array_equal(j[k], t[k])
    for shard in ((None, None), (2, 1)):
        jb = list(jpipeline.ranking_batches(jd, cfg, 8, seed=5, num_epochs=2,
                                            num_shards=shard[0], shard_id=shard[1]))
        tb = list(tpipeline.ranking_batches(td, port_config(cfg), 8, seed=5, num_epochs=2,
                                            num_shards=shard[0], shard_id=shard[1]))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            for group in a:
                for k in a[group]:
                    np.testing.assert_array_equal(a[group][k], b[group][k])
    assert list(tpipeline.prefetch(iter(range(5)))) == list(range(5))
    with pytest.raises(ValueError):
        tpipeline._resolve_shard(2, None)


# ---------------------------------------------------------------------------
# sparse embedding updates
# ---------------------------------------------------------------------------


def test_dedup_sum_matches_jax():
    ids = np.array([3, 1, 3, 7, 1, 1, 10, 10])  # 10 == vocab: padding
    g = np.arange(16, dtype=np.float32).reshape(8, 2)
    ju, js = jsparse.dedup_sum(jnp.asarray(ids), jnp.asarray(g), vocab=10)
    tu, ts = tsparse.dedup_sum(torch.from_numpy(ids), torch.from_numpy(g), vocab=10)
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    live = np.asarray(ju) < 10
    np.testing.assert_array_equal(_np(ts)[live], np.asarray(js)[live])


@pytest.mark.parametrize("mode", ["exact", "rowwise"])
def test_sparse_updates_match_jax_with_duplicates_and_sentinel(mode):
    """Duplicate ids and the id == vocab sentinel (dropped), two steps;
    atol 1e-6 (duplicates are summed in another order)."""
    rng = np.random.default_rng(0)
    v, d, lr = 20, 4, 0.3
    table = rng.normal(size=(v, d)).astype(np.float32)
    accum = np.full((v, d) if mode == "exact" else (v,), 0.1, np.float32)
    ids = np.array([[2, 5, 2], [v, 19, 5]])
    j_up = jsparse.sparse_update_table if mode == "exact" else jsparse.sparse_rowwise_update_table
    t_up = tsparse.sparse_update_table if mode == "exact" else tsparse.sparse_rowwise_update_table
    jt, ja = jnp.asarray(table), jnp.asarray(accum)
    tt, ta = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    for step in range(2):
        g = rng.normal(size=ids.shape + (d,)).astype(np.float32)
        jt, ja = j_up(jt, ja, jnp.asarray(ids), jnp.asarray(g), lr)
        out = t_up(tt, ta, torch.from_numpy(ids), torch.from_numpy(g), lr)
        assert out[0] is tt and out[1] is ta  # in place
        np.testing.assert_allclose(_np(tt), np.asarray(jt), atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=1e-6, rtol=0)
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(_np(tt)[untouched], table[untouched])


def test_sparse_lookup_gradient_matches_dense_adagrad():
    """tests/test_sparse_embed.py's case: dummy gradients + sparse update
    equal optax.adagrad on the dense table gradient (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    v, d, n, lr = 50, 8, 12, 0.1
    table0 = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, n)
    target = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table = torch.from_numpy(table0.copy())
    dummy = tsparse.make_dummy(ids.shape, d)
    loss = (tsparse.lookup_with_dummy(table, torch.from_numpy(ids), dummy) - target).square().sum()
    (g,) = torch.autograd.grad(loss, [dummy])
    tsparse.sparse_update_table(table, torch.full((v, d), 0.1), torch.from_numpy(ids), g, lr)
    jtab = jnp.asarray(table0)
    dense_g = jax.grad(lambda t: jnp.sum(jnp.square(
        jnp.take(t, jnp.asarray(ids), axis=0) - jnp.asarray(target.numpy()))))(jtab)
    opt = optax.adagrad(lr)
    upd, _ = opt.update(dense_g, opt.init(jtab), jtab)
    np.testing.assert_allclose(_np(table), np.asarray(optax.apply_updates(jtab, upd)),
                               rtol=1e-5, atol=1e-6)


def test_compact_valid_rows_matches_jax():
    rng = np.random.default_rng(1)
    v, d, n = 64, 8, 40
    ids = rng.integers(0, v, n)
    g = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < 0.5
    for budget in (32, int(valid.sum()) - 3):
        j = jsparse.compact_valid_rows(jnp.asarray(ids), jnp.asarray(g), jnp.asarray(valid),
                                       budget, v)
        t = tsparse.compact_valid_rows(torch.from_numpy(ids), torch.from_numpy(g),
                                       torch.from_numpy(valid), budget, v)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# optimizer, loss, metrics
# ---------------------------------------------------------------------------


OPT_CASES = [
    # (dense_optimizer, sparse_optimizer, grad scale): scale 100 engages the
    # global-norm clip at 90
    ("rmsprop", "adagrad", 1.0),
    ("rmsprop", "adagrad", 100.0),
    ("adam", "sgd", 100.0),
    ("adamw", "adagrad", 1.0),
]


@pytest.mark.parametrize("dense,sparse,scale", OPT_CASES)
def test_optimizer_steps_match_optax(dense, sparse, scale):
    """Two steps of make_ranking_optimizer against optax on a tree with a
    table (the sparse label), a matrix and a vector (adamw decays the
    matrix only); atol 1e-6 / rtol 1e-5."""
    cfg = dataclasses.replace(_tiny_cfg(), dense_optimizer=dense, sparse_optimizer=sparse,
                              dense_momentum=0.9, dense_lr=1e-2, sparse_lr=0.05,
                              dense_weight_decay=0.1)
    rng = np.random.default_rng(2)
    shapes = {"embedding": (6, 3), "kernel": (3, 4), "bias": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtree = {"tok": {"embedding": params["embedding"]},
             "dense": {"kernel": params["kernel"], "bias": params["bias"]}}
    jtree = jax.tree_util.tree_map(jnp.asarray, jtree)
    opt = joptimizer.make_ranking_optimizer(cfg)
    jstate = opt.init(jtree)
    names = {"embedding": "tok.embedding", "kernel": "dense.kernel", "bias": "dense.bias"}
    tparams = {names[k]: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = toptimizer.make_ranking_optimizer(port_config(cfg), sparse_names=["tok.embedding"])
    tstate = topt.init(tparams)
    for _ in range(2):
        g = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        jg = {"tok": {"embedding": jnp.asarray(g["embedding"])},
              "dense": {"kernel": jnp.asarray(g["kernel"]), "bias": jnp.asarray(g["bias"])}}
        upd, jstate = opt.update(jg, jstate, jtree)
        jtree = optax.apply_updates(jtree, upd)
        norm = topt.step(tparams, {names[k]: torch.from_numpy(v) for k, v in g.items()},
                         tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        flat = {"tok.embedding": jtree["tok"]["embedding"],
                "dense.kernel": jtree["dense"]["kernel"], "dense.bias": jtree["dense"]["bias"]}
        for k, v in flat.items():
            np.testing.assert_allclose(_np(tparams[k]), np.asarray(v), atol=1e-6, rtol=1e-5,
                                       err_msg=k)
    if scale > 1:
        assert float(norm) > cfg.gradient_clip_norm  # the clip engaged


def test_schedules_match_optax():
    cfg = dataclasses.replace(_tiny_cfg(), sparse_lr=0.02, sparse_lr_init=0.002,
                              sparse_lr_warmup_steps=10)
    j, t = joptimizer.sparse_lr_schedule(cfg), toptimizer.sparse_lr_schedule(port_config(cfg))
    for step in (0, 5, 10, 100):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)
    assert toptimizer.sparse_lr_schedule(port_config(_tiny_cfg())) == 0.05
    js = joptimizer.warmup_cosine_schedule(1e-3, 10, 100)
    ts = toptimizer.warmup_cosine_schedule(1e-3, 10, 100)
    for step in (0, 3, 10, 55, 100, 150):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5, atol=1e-12)


def test_bce_loss_and_streaming_auc_match_jax():
    rng = np.random.default_rng(3)
    logits = {t: rng.normal(scale=3, size=50).astype(np.float32) for t in ("ctr", "cvr")}
    labels = {t: (rng.random(50) < 0.3).astype(np.float32) for t in ("ctr", "cvr")}
    jl, jm = j_bce({k: jnp.asarray(v) for k, v in logits.items()},
                   {k: jnp.asarray(v) for k, v in labels.items()})
    tl, tm = t_bce({k: torch.from_numpy(v) for k, v in logits.items()},
                   {k: torch.from_numpy(v) for k, v in labels.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tm) == set(jm)
    ji, ju, jc = jmetrics.streaming_auc()
    ti, tu, tc = tmetrics.streaming_auc()
    js, ts = ji(), ti()
    for chunk in (slice(0, 20), slice(20, 50)):
        p = 1 / (1 + np.exp(-logits["ctr"][chunk]))
        js = ju(js, jnp.asarray(p), jnp.asarray(labels["ctr"][chunk]))
        ts = tu(ts, torch.from_numpy(p), torch.from_numpy(labels["ctr"][chunk]))
    np.testing.assert_allclose(float(tc(ts)), float(jc(js)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole: RankingTrainer steps against the JAX trainer
# ---------------------------------------------------------------------------


def _trainer_cfg(embed_dim, num_heads, mode):
    """_tiny_cfg with 48 items per sequence: S = 146, so layer 0 keeps 75
    queries and takes the kernel routes (Dh 128: the segmented kernel; Dh
    32: concat + the [B·H, L, Dh] whole-tile kernel). ``mode`` is the sparse
    update mode or ``dense``; ``+budget`` adds a scatter budget of 256 rows,
    below the 275-386 valid sequence rows of each of the tests' batches."""
    mode, _, budget = mode.partition("+")
    return dataclasses.replace(
        _tiny_cfg(), embed_dim=embed_dim, num_heads=num_heads, use_flash_attention=True,
        use_sparse_embedding_updates=mode != "dense",
        sparse_update_mode="exact" if mode == "dense" else mode, batch_size=4,
        sparse_scatter_budget=256 if budget else 0)


def _flax_state(tree, cfg):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree), cfg)


TRAINER_CASES = [
    # (embed_dim, num_heads, sparse mode, backward plain version it reaches)
    (128, 1, "rowwise", "band_attn_segkv_bwd_plain"),
    (128, 1, "exact", "band_attn_segkv_bwd_plain"),
    (64, 2, "rowwise", "band_attn_bh_bwd_plain"),
    (64, 2, "dense", "band_attn_bh_bwd_plain"),
    (64, 2, "rowwise+budget", "band_attn_bh_bwd_plain"),
]


@pytest.mark.parametrize("embed_dim,num_heads,mode,route", TRAINER_CASES)
def test_trainer_steps_match_jax_trainer(embed_dim, num_heads, mode, route, monkeypatch):
    """One and three steps from the same converted state on the same
    batches (dropout 0; the JAX kernels in interpret mode, the port's plain
    versions): loss (rtol 1e-5), the rows the scatter budget dropped
    (exactly), every parameter the flax tree has, the tables and the
    accumulators (atol 1e-5, rtol 1e-4); then evaluate()."""
    cfg = _trainer_cfg(embed_dim, num_heads, mode)
    tcfg = port_config(cfg)
    data = jsynthetic.make_ranking_data(cfg, num_samples=16, max_seq_per_feature=48, seed=0)
    batches = list(jpipeline.ranking_batches(data, cfg, batch_size=4, num_epochs=1))[:3]
    jt = JaxTrainer(cfg)
    js = jt.init_state(jax.random.key(0), batches[0])
    sparse = mode != "dense"
    if sparse:  # the JAX side starts at zero moments and 0.1 accumulators too
        assert all(float(jnp.abs(x).max()) == 0
                   for x in jax.tree_util.tree_leaves(js.opt_state[0]))
        accums = accums_from_flax(jax.tree_util.tree_map(np.asarray, js.opt_state[1]), tcfg)
    tt = RankingTrainer(tcfg, device="cpu")
    ts = tt.init_state(_flax_state(js.params, tcfg), accums=accums if sparse else None)

    calls = []
    plain = getattr(tfa, route)
    monkeypatch.setattr(tfa, route, lambda *a: calls.append(1) or plain(*a))
    for step, batch in enumerate(batches, 1):
        with pltpu.force_tpu_interpret_mode():
            js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
        ts, tm = tt._train_step(ts, tt._put_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert ("sparse_dropped_rows" in tm) == ("sparse_dropped_rows" in jm)
        if "sparse_dropped_rows" in jm:
            assert int(tm["sparse_dropped_rows"]) == int(jm["sparse_dropped_rows"]) > 0
        if step in (1, 3):
            ref = _flax_state(js.params, tcfg)
            for k, v in ref.items():
                if not torch.isnan(v).any():  # absent from the flax tree
                    np.testing.assert_allclose(_np(ts.params[k]), v.numpy(), atol=1e-5,
                                               rtol=1e-4, err_msg=f"step {step} {k}")
            if sparse:
                ja = accums_from_flax(jax.tree_util.tree_map(np.asarray, js.opt_state[1]),
                                      tcfg)
                for k, v in ja.items():
                    np.testing.assert_allclose(_np(ts.opt_state[1][k]), v.numpy(),
                                               atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == 3 and calls  # the kernel route's backward ran
    with pltpu.force_tpu_interpret_mode():
        jv = jt.evaluate(js, iter(batches))
    tv = tt.evaluate(ts, iter(batches))
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=1e-5, err_msg=k)


def test_keyless_rows_change_no_logit_and_no_gradient(monkeypatch):
    """On a query row with no valid key (a padded S position that sees no
    valid S key and no NS key) the kernels and the plain versions give
    different attention outputs (``band_attn_segkv_fwd_plain``'s note). The
    model never reads those rows: with the attention output of every such
    row set to arbitrary values, one ``RankingTrainer`` step on a batch whose
    first row has an empty history gives the same logits, the same
    gradients and the same new state, bit for bit. Layer 0 keeps every
    query (pyramid ratio 1.0), so the keyless rows reach the segmented
    kernel's route (its plain version on the CPU)."""
    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.models.ranking import MixedBlock

    cfg = port_config(dataclasses.replace(_trainer_cfg(128, 1, "rowwise"),
                                          pyramid_ratios=(1.0, 0.5)))
    data = tsynthetic.make_ranking_data(cfg, num_samples=8, max_seq_per_feature=48, seed=0)
    batch = next(tpipeline.ranking_batches(data, cfg, batch_size=4, num_epochs=1))
    batch["seq_valid"] = {k: np.array(v) for k, v in batch["seq_valid"].items()}
    for v in batch["seq_valid"].values():
        v[0] = False  # row 0: an empty history
    params = init_params(cfg, seed=0, device="cpu")
    attend = MixedBlock._attend_mixed
    keyless_rows = []

    def perturbed(self, q, k_s, v_s, s_valid, k_ns, v_ns, q_offset):
        out = attend(self, q, k_s, v_s, s_valid, k_ns, v_ns, q_offset)
        ls = s_valid.shape[1]
        pos = q_offset + torch.arange(q.shape[1])
        seen = s_valid.cumsum(1) > 0  # a valid S key at or before each position
        keyless = (pos < ls)[None] & ~seen[:, pos.clamp(max=ls - 1)]
        if q.shape[1] >= 64:
            keyless_rows.append(int(keyless.sum()))
        noise = np.random.default_rng(len(keyless_rows)).normal(0.0, 100.0, out.shape)
        return torch.where(keyless[:, :, None, None], torch.from_numpy(noise).to(out.dtype), out)

    def step(perturb: bool):
        trainer = RankingTrainer(cfg, device="cpu")
        state = trainer.init_state(params)
        seen = {}
        logits, grad = trainer._logits, torch.autograd.grad
        trainer._logits = lambda *a, **k: seen.setdefault("logits", logits(*a, **k))
        with monkeypatch.context() as m:
            m.setattr(torch.autograd, "grad",
                      lambda *a, **k: seen.setdefault("grads", grad(*a, **k)))
            plain = tfa.band_attn_segkv_fwd_plain
            m.setattr(tfa, "band_attn_segkv_fwd_plain",
                      lambda *a: seen.setdefault("kernel_route", True) and plain(*a))
            if perturb:
                m.setattr(MixedBlock, "_attend_mixed", perturbed)
            state, metrics = trainer._train_step(state, trainer._put_batch(batch))
        assert seen.get("kernel_route")
        return seen, state, metrics

    base, base_state, base_metrics = step(False)
    got, state, metrics = step(True)
    # the first layer's kernel call has keyless rows: row 0's first sequence
    assert keyless_rows and keyless_rows[0] >= 48
    for t in base["logits"]:
        assert torch.equal(got["logits"][t], base["logits"][t]), t
    assert len(got["grads"]) == len(base["grads"])
    for g, b in zip(got["grads"], base["grads"]):
        assert (g is None) == (b is None) and (g is None or torch.equal(g, b))
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[k], base_metrics[k]), k
    for k, v in base_state.params.items():
        assert torch.equal(state.params[k], v), k


def test_train_loop_history_and_best_params():
    cfg = port_config(dataclasses.replace(_trainer_cfg(64, 2, "rowwise"),
                                          use_flash_attention=False))
    data = tsynthetic.make_ranking_data(cfg, num_samples=24, max_seq_per_feature=8, seed=0)
    trainer = RankingTrainer(cfg, device="cpu")
    val = lambda: tpipeline.ranking_batches(data, cfg, 8, seed=2, num_epochs=1)
    state = trainer.train(tpipeline.ranking_batches(data, cfg, 4, seed=0), num_steps=6,
                          val_fn=val, eval_every=3, log_every=2, track_best_params=True)
    assert state.step == 6
    assert [h["step"] for h in trainer.history["train"]] == [2, 4, 6]
    assert [h["step"] for h in trainer.history["val"]] == [3, 6]
    assert all(np.isfinite(h["loss"]) for h in trainer.history["train"])
    assert trainer.best_val_step in (3, 6)
    best = trainer.best_params
    assert all(best[k] is not state.params[k] for k in best)
    m = trainer.evaluate(state._replace(params=best), val())
    assert 0.0 <= m["ctr_auc"] <= 1.0
    assert m["ctr_auc"] == trainer.best_val_metrics["ctr_auc"]


# ---------------------------------------------------------------------------
# dropout and remat
# ---------------------------------------------------------------------------


def _dropout_setup(remat=False):
    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.models.ranking import RankingModel
    from tests.test_torch_ranking import make_batch, torch_args

    cfg = port_config(dataclasses.replace(_tiny_cfg(), dropout_rate=0.3, use_remat=remat))
    model = RankingModel(cfg)
    model.load_state_dict(init_params(cfg, seed=0, device="cpu"))
    return model, torch_args(make_batch(_tiny_cfg(), seq_len=8))


def test_dropout_is_seeded_and_off_when_deterministic():
    model, args = _dropout_setup()
    with torch.no_grad():
        base = model(*args)
        det = model(*args, deterministic=True, generator=torch.Generator().manual_seed(1))
        a = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))
        b = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))
        c = model(*args, deterministic=False, generator=torch.Generator().manual_seed(2))
    for t in base:
        assert torch.equal(base[t], det[t]) and torch.equal(a[t], b[t])
        assert not torch.equal(a[t], base[t]) and not torch.equal(a[t], c[t])
    # flax nn.Dropout: kept values scaled by 1 / (1 - rate), the rest 0
    from recommend_tpu_torch.models.ranking import _dropout

    x = torch.ones(4000)
    y = _dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / 0.7]))
    assert abs((y == 0).float().mean().item() - 0.3) < 0.03


def test_remat_gives_identical_gradients_with_dropout():
    grads = []
    for remat in (False, True):
        model, args = _dropout_setup(remat)
        out = model(*args, deterministic=False, generator=torch.Generator().manual_seed(3))
        loss = sum(v.square().sum() for v in out.values())
        params = [p for _, p in sorted(model.named_parameters())]
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
