"""The port's DCNv2+DIN baseline held against the JAX package's
``models/din.py`` on the CPU, at float32.

The same numpy batches go through the flax model and the port on the same
weights (``convert.din_params_from_flax``): logits and the tokenizer's
``seq_item_embeds`` agree to 1e-5; an empty history pools to exact zeros;
``RankingTrainer(model=DINRankingModel(cfg))`` takes one and three steps as
the JAX trainer does (loss rtol 1e-5, parameters atol 1e-5 / rtol 1e-4,
sparse and dense table updates, with ``debug_metrics``); and the candidate
query's gradient reaches the sparse update's dummies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.data.synthetic import make_ranking_data
from recommend_tpu.models.din import DINRankingModel as JaxDIN
from recommend_tpu.models.losses import multi_task_bce_loss as j_bce
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.convert import accums_from_flax, din_params_from_flax, init_params
from recommend_tpu_torch.models.din import DINRankingModel
from recommend_tpu_torch.models.losses import multi_task_bce_loss
from recommend_tpu_torch.ops.sparse_embed import make_dummy
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_din import din_cfg
from tests.test_torch_ranking import jax_args, port_config

torch.set_num_threads(1)

ATOL = 1e-5


def _batches(cfg, n=3, bs=16, seq_len=10):
    data = make_ranking_data(cfg, num_samples=n * bs, max_seq_per_feature=seq_len, seed=0)
    return list(ranking_batches(data, cfg, bs, seed=0, num_epochs=1))[:n]


def _torch_args(batch):
    return tuple({k: torch.as_tensor(np.asarray(v)) for k, v in batch[g].items()}
                 for g in ("non_seq", "sequences", "seq_valid"))


def _setup(cfg, batch):
    jm = JaxDIN(cfg)
    jp = jm.init(jax.random.key(0), *jax_args(batch))
    tcfg = port_config(cfg)
    model = DINRankingModel(tcfg)
    model.load_state_dict(din_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), tcfg))
    return jm, jp, model.eval()


@pytest.mark.parametrize("empty", [False, True], ids=["history", "empty_history"])
def test_din_forward_and_seq_item_embeds_match_jax(empty):
    cfg = din_cfg()
    batch = _batches(cfg, 1)[0]
    if empty:
        batch["seq_valid"] = {k: np.zeros_like(v) for k, v in batch["seq_valid"].items()}
    jm, jp, model = _setup(cfg, batch)
    with torch.no_grad():
        got = model(*_torch_args(batch))
    want = jm.apply(jp, *jax_args(batch))
    assert set(got) == set(want) == set(cfg.tasks)
    for t in cfg.tasks:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), atol=ATOL, err_msg=t)
    sf = cfg.sequence_features[0]
    ids = np.asarray(batch["sequences"][sf])
    jkeys = jm.apply(jp, sf, jnp.asarray(ids),
                     method=lambda m, sf, ids: m.tokenizer.seq_item_embeds(sf, ids))
    with torch.no_grad():
        keys = model.tokenizer.seq_item_embeds(sf, torch.as_tensor(ids))
    np.testing.assert_allclose(keys.numpy(), np.asarray(jkeys), atol=ATOL)
    if empty:  # every sequence pools to exactly zero
        with torch.no_grad():
            pooled = model._target_attention(
                keys, torch.zeros(ids.shape, dtype=torch.bool), keys[:, 0])
        assert torch.equal(pooled, torch.zeros_like(pooled))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_din_trainer_steps_match_the_jax_trainer(sparse):
    """One and three steps from the same converted state on the same batches
    (dropout 0), with the debug metrics on both sides (the JAX trainer adds
    them on its sparse path). ``attn_out.bias`` has no gradient but rounding
    noise (see below) and is held to the optimizer's step bound instead."""
    cfg = dataclasses.replace(din_cfg(), use_sparse_embedding_updates=sparse,
                              sparse_update_mode="rowwise", batch_size=16)
    tcfg = port_config(cfg)
    batches = _batches(cfg)
    jt = JaxTrainer(cfg, model=JaxDIN(cfg), debug_metrics=True)
    js = jt.init_state(jax.random.key(0), batches[0])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tt = RankingTrainer(tcfg, model=DINRankingModel(tcfg), debug_metrics=True, device="cpu")
    ts = tt.init_state(din_params_from_flax(np_tree(js.params), tcfg),
                       accums=accums_from_flax(np_tree(js.opt_state[1]), tcfg) if sparse
                       else None)
    for step, batch in enumerate(batches, 1):
        js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
        ts, tm = tt._train_step(ts, tt._put_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        if sparse:
            for k in ("ctr_logit_max", "cvr_logit_max", "item_table_rms",
                      "dense_param_norm"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        if step in (1, 3):
            ref = din_params_from_flax(np_tree(js.params), tcfg)
            for k, v in ref.items():
                got = ts.params[k].detach().numpy()
                if k == "attn_out.bias":
                    # a shift of every attention logit leaves the softmax as
                    # it is: this bias's gradient is rounding noise on both
                    # sides, which adam scales to steps of up to dense_lr
                    assert np.abs(got - v.numpy()).max() <= step * cfg.dense_lr
                    continue
                np.testing.assert_allclose(got, v.numpy(), atol=ATOL, rtol=1e-4,
                                           err_msg=f"step {step} {k}")
    assert ts.step == 3
    jv = jt.evaluate(js, iter(batches))
    tv = tt.evaluate(ts, iter(batches))
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=ATOL, err_msg=k)


def test_din_query_gradient_reaches_the_sparse_dummies():
    """The per-lookup dummy gradients, scattered into table shape, equal
    the dense table gradients (the item-feature tables feed both the NS
    concat and the candidate query), and equal the JAX dummies' gradients."""
    cfg = din_cfg()
    batch = _batches(cfg, 1, bs=16)[0]
    jm, jp, model = _setup(cfg, batch)
    args = _torch_args(batch)
    labels = {k: torch.as_tensor(np.asarray(v)) for k, v in batch["labels"].items()}
    params = dict(model.named_parameters())
    dense_loss = multi_task_bce_loss(model(*args), labels)[0]
    names = [n for n in params if n.startswith("tokenizer.") and n.endswith("weight")
             and "proj" not in n]
    g_tables = dict(zip(names, torch.autograd.grad(dense_loss, [params[n] for n in names])))
    dummies = {f"ns_{f}": make_dummy(args[0][f].shape, cfg.feature_embed_dim)
               for f in cfg.non_seq_features}
    dummies.update({f"seq_{sf}": make_dummy(args[1][sf].shape, cfg.seq_item_feature_dim)
                    for sf in cfg.sequence_features})
    sparse_loss = multi_task_bce_loss(model(*args, dummies=dummies), labels)[0]
    g_dummy = dict(zip(dummies, torch.autograd.grad(sparse_loss, list(dummies.values()))))
    for f in cfg.non_seq_features:
        table_g = g_tables[f"tokenizer.embeds.{f}.weight"]
        scat = torch.zeros_like(table_g).index_add_(0, args[0][f], g_dummy[f"ns_{f}"])
        np.testing.assert_allclose(scat.numpy(), table_g.numpy(), atol=2e-5, err_msg=f)
    table_g = g_tables["tokenizer.item_embed.weight"]
    scat = torch.zeros_like(table_g)
    for sf in cfg.sequence_features:
        scat.index_add_(0, args[1][sf].reshape(-1),
                        g_dummy[f"seq_{sf}"].reshape(-1, cfg.seq_item_feature_dim))
    np.testing.assert_allclose(scat.numpy(), table_g.numpy(), atol=2e-5)

    jdummies = {k: jnp.zeros(v.shape, jnp.float32) for k, v in dummies.items()}
    jgrad = jax.grad(lambda d: j_bce(jm.apply(jp, *jax_args(batch), dummies=d),
                                     batch["labels"])[0])(jdummies)
    for k, g in g_dummy.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), atol=ATOL, err_msg=k)


def test_din_trains_from_its_own_init_with_dropout():
    """``train()`` with ``model=`` draws DIN's parameters through
    ``init_params(model=...)`` (the model's names and shapes, the shared
    init rules) and trains with dropout on: the loss stays finite and the
    item table moves."""
    cfg = port_config(dataclasses.replace(din_cfg(), use_sparse_embedding_updates=True,
                                          sparse_update_mode="rowwise", dropout_rate=0.1,
                                          batch_size=16))
    model = DINRankingModel(cfg)
    params = init_params(cfg, seed=0, device="cpu", model=model)
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    assert "tokenizer.ns_proj.weight" not in params and "tokenizer.sep_token" not in params
    trainer = RankingTrainer(cfg, model=model, device="cpu")
    state = trainer.train(iter(_batches(cfg, 4)), num_steps=4, log_every=1)
    assert state.step == 4
    assert all(np.isfinite(h["loss"]) for h in trainer.history["train"])
    table = "tokenizer.item_embed.weight"
    assert not torch.equal(state.params[table], params[table])
