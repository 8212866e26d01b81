"""The port's ``RankingTrainer(mesh=...)`` and its checkpoints on a 2 x 2
mesh of gloo ranks.

- two steps in rowwise and exact sparse mode at ``tests/test_parallel.py``'s
  flagship config (a 16,384-row item table, row-sharded over ``model``; 4
  NS tokens, their stacks split over ``model``) against the JAX trainer's
  single-device steps on the same global batches from one state: loss rtol
  1e-5, parameters and accumulators atol 2e-5 (JAX's mesh tolerances), the
  accumulators with the port's single-device rtol 1e-4 besides; then
  ``evaluate``. The item table, its accumulator, the NS stacks and their
  rmsprop state are held as blocks;
- the same config with dropout 0.1 and a scatter budget below the batch's
  valid rows, against the port's own single-device steps from the same
  generator: the masks are drawn for the global batch, and the mesh
  compacts the global rows on the device where one device compacts them on
  the host (loss 1e-6 relative, parameters 1e-6);
- checkpoints: a mesh run saved at step 1 resumes bit-equal to the
  unbroken run at step 2; the mesh's checkpoint restores into one device
  bit for bit, and one device's into the mesh.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import ranking_batches as j_batches
from recommend_tpu.data.synthetic import make_ranking_data as j_data
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.convert import accums_from_flax, params_from_flax
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests import torch_parallel_cases as cases
from tests.test_parallel import _sparse_flagship_cfg
from tests.test_torch_ranking import port_config
from tests.torch_parallel_ranks import run_ranks

torch.set_num_threads(1)

LOSS_RTOL, STATE_ATOL, ACCUM_RTOL = 1e-5, 2e-5, 1e-4
MODES = ("rowwise", "exact")


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _batches(cfg, n=2):
    data = j_data(cfg, num_samples=64, max_seq_per_feature=8, seed=0)
    return list(j_batches(data, cfg, batch_size=8, seed=0, num_epochs=1))[:n]


def _jax_steps(mode):
    cfg = _sparse_flagship_cfg(mode)
    tcfg = port_config(cfg)
    batches = _batches(cfg)
    jt = JaxTrainer(cfg)
    js = jt.init_state(jax.random.key(0), batches[0])
    case = dict(cfg=tcfg.to_dict(), mesh=(2, 2), batches=batches,
                params=params_from_flax(_np_tree(js.params), tcfg),
                accums=accums_from_flax(_np_tree(js.opt_state[1]), tcfg))
    refs = []
    for batch in batches:
        js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
        refs.append(dict(metrics={k: float(v) for k, v in jm.items()},
                         params=params_from_flax(_np_tree(js.params), tcfg),
                         accums=accums_from_flax(_np_tree(js.opt_state[1]), tcfg)))
    return case, refs, jt.evaluate(js, iter(batches))


def _dropout_case():
    cfg = dataclasses.replace(_sparse_flagship_cfg("rowwise"), dropout_rate=0.1,
                              sparse_scatter_budget=40)
    tcfg = port_config(cfg)
    from recommend_tpu_torch.convert import init_params

    return dict(cfg=tcfg.to_dict(), mesh=(2, 2), batches=_batches(cfg),
                params=init_params(tcfg, seed=0, device="cpu"), accums=None, seed=3)


@pytest.fixture(scope="module")
def refs():
    return {mode: _jax_steps(mode) for mode in MODES}


@pytest.fixture(scope="module")
def dropout_case():
    return _dropout_case()


@pytest.fixture(scope="module")
def ranks(refs, dropout_case, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    inputs = {"steps": {**{m: refs[m][0] for m in MODES}, "dropout": dropout_case},
              "checkpoint": dict(dropout_case, dir=str(root))}
    # a checkpoint of one device at step 2 for the mesh to restore
    one = RankingTrainer(RankingConfig_of(dropout_case), device="cpu",
                         checkpoint_dir=str(root / "one"))
    gen = torch.Generator().manual_seed(0)
    state = one.init_state(dropout_case["params"], generator=gen)
    for batch in dropout_case["batches"]:
        state, _ = one._train_step(state, one._put_batch(batch), gen)
    one._save(state, gen)
    return run_ranks(4, cases.ranking, inputs), root, state


def RankingConfig_of(case):
    from recommend_tpu_torch.config import RankingConfig

    return RankingConfig.from_dict(case["cfg"])


@pytest.mark.parametrize("mode", MODES)
def test_two_mesh_steps_match_the_jax_single_device_steps(ranks, refs, mode):
    _, jax_steps, jax_eval = refs[mode]
    results = ranks[0]
    got = results[0]["steps"][mode]
    for step, (g, ref) in enumerate(zip(got["steps"], jax_steps), 1):
        assert set(g["metrics"]) == set(ref["metrics"])
        np.testing.assert_allclose(g["metrics"]["loss"], ref["metrics"]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                                   rtol=1e-4)
        for k, v in ref["params"].items():
            if not torch.isnan(v).any():  # absent from the flax tree
                np.testing.assert_allclose(g["params"][k], v.numpy(), atol=STATE_ATOL,
                                           err_msg=f"step {step} {k}")
        for k, v in ref["accums"].items():
            np.testing.assert_allclose(g["accums"][k], v.numpy(), atol=STATE_ATOL,
                                       rtol=ACCUM_RTOL, err_msg=f"step {step} {k}")
    for k, v in jax_eval.items():
        np.testing.assert_allclose(got["eval"][k], v, atol=1e-5, err_msg=k)
    for other in results[1:]:  # every rank reports the same global metrics
        assert [s["metrics"] for s in other["steps"][mode]["steps"]] == \
            [s["metrics"] for s in got["steps"]]


@pytest.mark.parametrize("mode", MODES)
def test_the_item_table_accumulator_and_ns_stacks_are_held_sharded(ranks, mode):
    for got in ranks[0]:
        blocks = got["steps"][mode]["blocks"]
        item = "tokenizer.item_embed.weight"
        assert blocks[item] == (8192, 8)
        assert blocks[f"accum:{item}"] == ((8192,) if mode == "rowwise" else (8192, 8))
        assert blocks["tokenizer.embeds.user_id.weight"] == (100, 8)  # replicated
        for layer in range(3):
            for stack in ("q_ns", "k_ns", "v_ns", "ffn_ns_in", "ffn_ns_out"):
                name = f"blocks.{layer}.{stack}"
                assert blocks[name][0] == 2, name  # 4 NS tokens over 2 ranks
                assert blocks[f"opt:{name}"] == blocks[name]  # rmsprop state with it
            assert blocks[f"blocks.{layer}.q_s.weight"][0] == 32  # replicated


def test_a_mesh_step_with_dropout_and_a_budget_matches_the_port_on_one_device(
        ranks, dropout_case):
    trainer = RankingTrainer(RankingConfig_of(dropout_case), device="cpu")
    state = trainer.init_state(dropout_case["params"])
    gen = torch.Generator().manual_seed(dropout_case["seed"])
    got = ranks[0][0]["steps"]["dropout"]["steps"]
    for step, batch in enumerate(dropout_case["batches"]):
        state, metrics = trainer._train_step(state, trainer._put_batch(batch), gen)
        assert float(metrics["sparse_dropped_rows"]) > 0  # the budget cut rows
        for k, v in metrics.items():
            np.testing.assert_allclose(got[step]["metrics"][k], float(v), rtol=1e-6,
                                       err_msg=k)
        for k, v in state.params.items():
            np.testing.assert_allclose(got[step]["params"][k], v.detach().numpy(),
                                       atol=1e-6, err_msg=f"step {step} {k}")
        for k, v in state.opt_state[1].items():
            np.testing.assert_allclose(got[step]["accums"][k], v.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_a_mesh_checkpoint_resumes_bit_equal_into_the_mesh(ranks):
    for got in ranks[0]:
        ck = got["checkpoint"]
        assert ck["resumed_step"] == 1
        _equal(ck["resumed"], ck["unbroken"])


def test_a_mesh_checkpoint_restores_into_one_device_and_back(ranks, dropout_case):
    results, root, one_state = ranks
    ck = results[0]["checkpoint"]
    # the mesh's checkpoint (step 1) in one device: the gathered state, bit for bit
    one = RankingTrainer(RankingConfig_of(dropout_case), device="cpu",
                         checkpoint_dir=str(root / "mesh"))
    restored = one.init_state()
    assert restored.step == 1
    _equal({k: v.detach().numpy() for k, v in restored.params.items()}, ck["at_save"][0])
    _equal(cases._np(restored.opt_state), ck["at_save"][1])
    # one device's checkpoint (step 2) in the mesh
    assert ck["from_one_device_step"] == 2
    _equal(ck["from_one_device"][0],
           {k: v.detach().numpy() for k, v in one_state.params.items()})
    _equal(ck["from_one_device"][1], cases._np(one_state.opt_state))
