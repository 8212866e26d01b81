"""The port's retrieval mesh paths held against the JAX package on gloo
ranks.

- ``RetrievalTrainer(mesh=...)``: two steps at 2 data ranks (single,
  seq2seq and masked modes, sparse updates off) and at 2 x 2 (the
  32,768-row video table row-sharded over ``model``: single and masked with
  rowwise sparse updates, seq2seq with exact updates at a scatter budget
  below the batch's valid rows, which the mesh compacts on the device)
  against the JAX trainer's single-device steps on the same global batches
  from one state (step 1's learning rate is 0 after the one-step warmup:
  step 2 moves the dense parameters), masked mode handed JAX's positions;
  then ``evaluate``.
  JAX's own mesh tolerances (``tests/test_parallel.py``): loss rtol 1e-5,
  parameters and accumulators atol 2e-5, the accumulators (sums of squared
  gradients, up to ~40 here) with the port's single-device rtol 1e-4
  besides (``tests/test_torch_retrieval_training_steps.py``: one device's
  port and JAX differ by up to 3.6e-5 there); each attention's ``k_proj.bias``
  (a zero true gradient, so adam moves it by rounding noise) within twice
  the step's learning rate. The video table and its accumulator are held
  as 16,384-row blocks;
- ``RetrievalIndex(mesh=...)`` at 4 data ranks: ``fetch_items`` (the
  all-to-all protocol, seeds padded with the sentinel), ``similar_items``
  and ``search`` (the sharded scan) against the JAX single-device index
  (``tests/test_parallel.py``'s sharded-index test), then ``update_items``
  written into each rank's rows;
- with dropout 0.1 in masked mode at 2 x 2, the mesh's two steps against
  the port's on one device from one generator;
- ``RetrievalEvaluator(mesh=...)`` at 4 data ranks against the port's
  evaluator on one device.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import retrieval_batches as j_batches
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu.training.trainer import RetrievalTrainer as JaxTrainer
from tests import torch_parallel_cases as cases
from tests.test_torch_retrieval_training_steps import (
    BATCH,
    converted,
    jax_mask_positions,
    port_cfg,
    tiny_cfg,
)
from tests.torch_parallel_ranks import run_ranks

torch.set_num_threads(1)

LOSS_RTOL, STATE_ATOL, ACCUM_RTOL = 1e-5, 2e-5, 1e-4

# (name, mesh, mode, sparse, budget, video vocabulary)
STEPS = [
    ("single_data2", (2, 1), "single", "off", 0, 500),
    ("seq2seq_data2", (2, 1), "seq2seq", "off", 0, 500),
    ("masked_data2", (2, 1), "masked", "off", 0, 500),
    ("single_rowwise_2x2", (2, 2), "single", "rowwise", 0, 32768),
    ("masked_rowwise_2x2", (2, 2), "masked", "rowwise", 0, 32768),
    ("seq2seq_exact_budget_2x2", (2, 2), "seq2seq", "exact", 40, 32768),
]
WORLD = {name: mesh[0] * mesh[1] for name, mesh, *_ in STEPS}
# the cases whose evaluate() is held against JAX's (each compiles its own)
EVALUATED = ("single_data2", "single_rowwise_2x2")


def _jax_steps(name, mesh, mode, sparse, budget, vocab, starts):
    """The case the ranks run and the JAX trainer's state after two steps
    (the warmup makes step 1's learning rate 0: step 2 moves the dense
    parameters). ``starts`` keeps one initial state per config: the modes
    share the tower's parameters."""
    cfg = tiny_cfg(sparse, budget, video_vocab_size=vocab)
    data = j_data(cfg, num_users=20, num_videos=200, seed=0)
    batches = list(j_batches(data, cfg, batch_size=BATCH, seed=0, num_epochs=1,
                             use_native=False))[:2]
    jt = JaxTrainer(cfg, total_steps=10, mode=mode)
    key = (sparse, budget, vocab)
    if key not in starts:
        starts[key] = jt.init_state(jax.random.key(0), batches[0])
    js = jax.tree_util.tree_map(jnp.copy, starts[key])  # the step donates its state
    tcfg = port_cfg(cfg)
    params, opt, accums = converted(js, tcfg)
    draws = SimpleNamespace(num_mask=jt._num_mask, tail_r=jt._tail_r)
    pos = ([jax_mask_positions(cfg, draws, step) for step in range(2)]
           if mode == "masked" else [None, None])
    case = dict(cfg=tcfg.to_dict(), mesh=mesh, mode=mode, params=params, opt=opt,
                accums=accums, batches=batches, pos=pos)
    for batch in batches:
        js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
    ref = dict(metrics={k: float(v) for k, v in jm.items()}, state=converted(js, tcfg),
               eval=jt.evaluate(js, iter(batches)) if name in EVALUATED else None)
    return case, ref


@pytest.fixture(scope="module")
def refs():
    starts = {}
    return {s[0]: _jax_steps(*s, starts) for s in STEPS}


def _index_case():
    from recommend_tpu.models.retrieval import RetrievalTower
    from recommend_tpu.serving.retrieval_service import RetrievalIndex
    from recommend_tpu_torch.convert import retrieval_params_from_flax
    from recommend_tpu.config import get_config

    cfg = get_config(
        "retrieval_small",
        embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, max_seq_len=16,
        compression_schedule=((8, 4), (8, 1)), video_vocab_size=500,
        dropout_rate=0.0, compute_dtype="float32", top_k=20,
    )
    data = j_data(cfg, num_users=10, num_videos=256, seed=0)
    model = RetrievalTower(cfg)
    batch = next(iter(j_batches(data, cfg, batch_size=4, num_epochs=1, use_native=False)))
    params = jax.jit(model.init)(
        jax.random.key(0),
        {k: jnp.asarray(v) for k, v in batch["history"].items()},
        jnp.asarray(batch["history_valid"]),
    )
    single = RetrievalIndex(cfg, model, params, embed_batch=64)
    corpus = data.corpus_features()
    single.build(corpus)
    seeds = [0, 7, 100, 255, 64]  # 5 seeds pad to 8 for 4 ranks
    rng = np.random.default_rng(0)
    interests = rng.normal(size=(3, cfg.num_query_tokens, 32)).astype(np.float32)
    # new features for 3 items, one on each of three shards
    upd_ids = np.array([7, 100, 255])
    update = {k: np.asarray(v)[upd_ids[::-1]] for k, v in corpus.items()}
    update["video_id"] = upd_ids
    ref = {"fetch": np.asarray(single.fetch_items(seeds)),
           "similar": single.similar_items(seeds, top_k=10),
           "search": single.search(jnp.asarray(interests), 20)}
    single.update_items(update)
    ref["after_update"] = np.asarray(single.fetch_items(seeds))
    from recommend_tpu_torch import config as tconfig

    tcfg = tconfig.RetrievalConfig.from_dict(cfg.to_dict())
    case = dict(cfg=tcfg.to_dict(), mesh=(4, 1),
                params=retrieval_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                  tcfg),
                corpus=corpus, seeds=seeds, interests=interests, update=update)
    return case, ref


@pytest.fixture(scope="module")
def index_ref():
    return _index_case()


def _dropout_case():
    """The 2 x 2 rowwise config with dropout 0.1, for the port alone (JAX
    draws other masks): masked mode, its positions and masks drawn for the
    global batch from the trainer's generator."""
    from recommend_tpu_torch.convert import init_retrieval_params

    cfg = tiny_cfg("rowwise", 0, video_vocab_size=32768, dropout_rate=0.1)
    data = j_data(cfg, num_users=20, num_videos=200, seed=0)
    batches = list(j_batches(data, cfg, batch_size=BATCH, seed=0, num_epochs=1,
                             use_native=False))[:2]
    tcfg = port_cfg(cfg)
    return dict(cfg=tcfg.to_dict(), mesh=(2, 2), mode="masked", batches=batches,
                pos=[None, None], params=init_retrieval_params(tcfg, seed=0, device="cpu"),
                opt=None, accums=None, seed=5)


@pytest.fixture(scope="module")
def dropout_case():
    return _dropout_case()


@pytest.fixture(scope="module")
def ranks(refs, index_ref, dropout_case):
    out = {}
    for world in (2, 4):
        inputs = {"steps": {n: refs[n][0] for n in refs if WORLD[n] == world}}
        if world == 4:
            inputs["steps"]["dropout_masked_2x2"] = dropout_case
        if world == 4:
            inputs["index"] = {"data4": index_ref[0]}
        out[world] = run_ranks(world, cases.retrieval, inputs)
    return out


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_a_mesh_step_matches_the_jax_single_device_step(ranks, refs, name):
    case, ref = refs[name]
    results = ranks[WORLD[name]]
    got = results[0]["steps"][name]
    jm = ref["metrics"]
    assert set(got["metrics"]) == set(jm)
    np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-4)
    assert got["metrics"]["in_batch_accuracy"] == pytest.approx(jm["in_batch_accuracy"],
                                                                abs=1e-6)
    if "sparse_dropped_rows" in jm:
        assert got["metrics"]["sparse_dropped_rows"] == jm["sparse_dropped_rows"] > 0
    params, _, accums = ref["state"]
    cfg = case["cfg"]
    bound = 2 * cfg["learning_rate"] * (1.1 + cfg["weight_decay"])  # lr(0) = 0, lr(1) = peak
    for k, v in params.items():
        if k.endswith("attn.k_proj.bias"):
            assert np.abs(got["params"][k] - v.numpy()).max() <= bound, k
        else:
            np.testing.assert_allclose(got["params"][k], v.numpy(), atol=STATE_ATOL,
                                       err_msg=k)
    if accums is not None:  # sums of squared gradients, up to ~40 here
        for k, v in accums.items():
            np.testing.assert_allclose(got["accums"][k], v.numpy(), atol=STATE_ATOL,
                                       rtol=ACCUM_RTOL, err_msg=k)
    for k, v in (ref["eval"] or {}).items():
        np.testing.assert_allclose(got["eval"][k], v, atol=1e-5, err_msg=k)
    # every rank reports the same global metrics
    for other in results[1:]:
        assert other["steps"][name]["metrics"] == got["metrics"]


@pytest.mark.parametrize("name", [s[0] for s in STEPS] + ["dropout_masked_2x2"])
def test_a_mesh_step_matches_the_port_single_device_step(ranks, refs, dropout_case, name):
    """The same steps through the port on one device: only the order of
    the gradients' sums differs, so the tolerances are tighter (loss 1e-6
    relative, parameters 1e-6, accumulators 1e-5 relative). With dropout,
    the mesh draws the masks and the masked positions for the global batch
    and keeps its rows: the same as one device's."""
    from recommend_tpu_torch.config import RetrievalConfig
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    case = dropout_case if name == "dropout_masked_2x2" else refs[name][0]
    trainer = RetrievalTrainer(RetrievalConfig.from_dict(case["cfg"]), total_steps=10,
                               mode=case["mode"], device="cpu")
    state = trainer.init_state(case["params"], opt_state=case["opt"], accums=case["accums"])
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    for batch, pos in zip(case["batches"], case["pos"]):
        state, metrics = trainer._train_step(state, trainer._put_batch(batch), gen,
                                             mask_positions=pos)
    got = ranks[WORLD.get(name, 4)][0]["steps"][name]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-6, err_msg=k)
    bound = 2 * case["cfg"]["learning_rate"] * (1.1 + case["cfg"]["weight_decay"])
    for k, v in state.params.items():
        if k.endswith("attn.k_proj.bias"):
            assert np.abs(got["params"][k] - v.detach().numpy()).max() <= bound, k
        else:
            np.testing.assert_allclose(got["params"][k], v.detach().numpy(), atol=1e-6,
                                       err_msg=k)
    if got["accums"] is not None:
        for k, v in state.opt_state[1].items():
            np.testing.assert_allclose(got["accums"][k], v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    single_eval = trainer.evaluate(state, iter(case["batches"]))
    for k, v in single_eval.items():
        np.testing.assert_allclose(got["eval"][k], v, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", [s[0] for s in STEPS if s[1] == (2, 2)])
def test_the_video_table_and_its_accumulator_are_row_sharded(ranks, name):
    for got in ranks[4]:
        blocks = got["steps"][name]["blocks"]
        assert blocks["embed.tables.video_id.weight"] == (16384, 32)
        rowwise = "rowwise" in name
        assert blocks["accum:embed.tables.video_id.weight"] == ((16384,) if rowwise
                                                               else (16384, 32))
        # small tables stay replicated
        assert blocks["embed.tables.category.weight"][0] == 100


def test_sharded_index_fetch_and_similar_items_match_single_device(ranks, index_ref):
    _, ref = index_ref
    for r, got in enumerate(ranks[4]):
        res = got["index"]["data4"]
        assert res["sharded"] and res["block"] == (64, 32), r
        np.testing.assert_allclose(res["fetch"], ref["fetch"], atol=1e-6)
        (s_sc, s_ids), (d_sc, d_ids) = res["similar"], ref["similar"]
        np.testing.assert_array_equal(s_ids, np.asarray(d_ids))
        np.testing.assert_allclose(s_sc, np.asarray(d_sc), atol=1e-5)


def test_sharded_index_search_and_update_match_single_device(ranks, index_ref):
    _, ref = index_ref
    for got in ranks[4]:
        res = got["index"]["data4"]
        (s_sc, s_ids), (d_sc, d_ids) = res["search"], ref["search"]
        np.testing.assert_array_equal(s_ids, np.asarray(d_ids))
        np.testing.assert_allclose(s_sc, np.asarray(d_sc), atol=1e-5)
        np.testing.assert_allclose(res["after_update"], ref["after_update"], atol=1e-6)
        assert res["after_update_block"] == (64, 32)  # written in place, still sharded


def test_sharded_evaluator_matches_the_port_on_one_device(ranks, index_ref):
    """``RetrievalEvaluator(mesh=...)`` hands the mesh to its index, whose
    corpus it shards: the full-corpus metrics equal one device's."""
    from recommend_tpu_torch.config import RetrievalConfig
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator

    case, _ = index_ref
    cfg = RetrievalConfig.from_dict(case["cfg"])
    data, batches = cases.evaluation_data(cfg)
    single = RetrievalEvaluator(cfg, case["params"], device="cpu").evaluate_retrieval(
        data, batches)
    for got in ranks[4]:
        res = got["index"]["data4"]
        assert res["evaluator_sharded"]
        assert set(res["evaluation"]) == set(single)
        for k, v in single.items():
            np.testing.assert_allclose(res["evaluation"][k], v, atol=1e-6, err_msg=k)
