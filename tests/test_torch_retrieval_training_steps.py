"""The port's ``RetrievalTrainer`` held against the JAX trainer on the CPU.

Both trainers start from one state, the JAX trainer's, converted
(``convert.retrieval_params_from_flax``, ``retrieval_opt_state_from_flax``),
and take the same batches at float32 with dropout 0; masked mode is handed
the positions JAX drew (``fold_in(fold_in(key, step), 7)``). Every mode runs
with sparse updates off, rowwise and exact, the exact case at a scatter
budget below the batch's valid rows (so the host compaction and
``sparse_dropped_rows`` are compared). Tolerances: loss rtol 1e-5, grad norm
rtol 1e-4, parameters, tables and accumulators atol 1e-5 / rtol 1e-4,
``evaluate`` atol 1e-5.

Two exceptions, both in the arithmetic and not in the port:

- each attention's ``k_proj.bias`` has a zero true gradient (it adds one
  constant to every logit of a softmax row), so its gradient is rounding
  noise and adam moves it by up to lr a step whatever the noise's size: it
  is held to twice the steps' learning rates, not to 1e-5;
- the max over interests routes each score's gradient through one interest,
  and two sides whose states differ by rounding after a step can pick
  different interests where two nearly tie, which changes a gradient row by
  ~1% and turns near-zero elements into ±lr under adam. So the three-step
  comparisons run at one interest; the one-step comparisons, from one
  state, run at the default four.
"""

import jax
import numpy as np
import pytest
import torch

from recommend_tpu.config import get_config
from recommend_tpu.data.pipeline import retrieval_batches as j_batches
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu.training.trainer import RetrievalTrainer as JaxTrainer
from recommend_tpu_torch import config as tconfig
from recommend_tpu_torch.convert import retrieval_opt_state_from_flax, retrieval_params_from_flax
from recommend_tpu_torch.training.trainer import RetrievalTrainer

torch.set_num_threads(1)

LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
STATE_ATOL, STATE_RTOL = 1e-5, 1e-4
EVAL_ATOL = 1e-5
BATCH = 8


def tiny_cfg(sparse="off", budget=0, **overrides):
    """``tests/test_trainer.py``'s tiny config (embed 32, one layer, 16
    items: two groups of 4, then 8 raw, so the raw tail R = 8), with a
    one-step warmup so that step 1 learns."""
    kw = dict(embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, max_seq_len=16,
              compression_schedule=((8, 4), (8, 1)), video_vocab_size=500, warmup_steps=1,
              batch_size=BATCH, dropout_rate=0.0, compute_dtype="float32")
    if sparse != "off":
        kw.update(use_sparse_embedding_updates=True, sparse_update_mode=sparse,
                  sparse_scatter_budget=budget)
    kw.update(overrides)
    return get_config("retrieval_small", **kw)


def port_cfg(cfg):
    return tconfig.RetrievalConfig.from_dict(cfg.to_dict())


def batches_for(cfg, n, seed=0):
    data = j_data(cfg, num_users=20, num_videos=200, seed=seed)
    return list(j_batches(data, cfg, batch_size=BATCH, seed=seed, num_epochs=1,
                          use_native=False))[:n]


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def converted(js, tcfg):
    """(params, adamw state, accumulators) of a JAX TrainState."""
    opt, accums = retrieval_opt_state_from_flax(_np_tree(js.opt_state), tcfg)
    return retrieval_params_from_flax(_np_tree(js.params), tcfg), opt, accums


def jax_mask_positions(cfg, trainer, step, seed=0):
    """The positions JAX's masked step draws at ``step``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step), 7)
    u = jax.random.randint(key, (BATCH, trainer.num_mask), 0, trainer.tail_r)
    return torch.as_tensor(np.array(cfg.max_seq_len - trainer.tail_r + u))


def both_step(jt, js, tt, ts, batch, cfg, mode):
    pos = jax_mask_positions(cfg, tt, int(js.step)) if mode == "masked" else None
    js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
    ts, tm = tt._train_step(ts, tt._put_batch(batch), mask_positions=pos)
    return js, jm, ts, tm


def assert_metrics_close(tm, jm):
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
    assert float(tm["in_batch_accuracy"]) == float(jm["in_batch_accuracy"])
    if "sparse_dropped_rows" in jm:
        assert int(tm["sparse_dropped_rows"]) == int(jm["sparse_dropped_rows"])


def assert_state_close(ts, js, tcfg, lr_sum):
    """Parameters, tables and accumulators; the zero-gradient key biases
    within twice the steps' learning rates (see the module docstring)."""
    ref, _, accums = converted(js, tcfg)
    for k, v in ref.items():
        got = ts.params[k].detach().numpy()
        if k.endswith("attn.k_proj.bias"):
            assert np.abs(got - v.numpy()).max() <= 2 * lr_sum * (1.1 + tcfg.weight_decay), k
        else:
            np.testing.assert_allclose(got, v.numpy(), atol=STATE_ATOL, rtol=STATE_RTOL,
                                       err_msg=k)
    if accums is not None:
        for k, v in accums.items():
            np.testing.assert_allclose(ts.opt_state[1][k].numpy(), v.numpy(), atol=STATE_ATOL,
                                       rtol=STATE_RTOL, err_msg=k)


def start(cfg, mode, total_steps=10):
    """(JAX trainer, its state, the port trainer, its state from the JAX
    state, the batches)."""
    tcfg = port_cfg(cfg)
    batches = batches_for(cfg, 3)
    jt = JaxTrainer(cfg, total_steps=total_steps, mode=mode)
    js = jt.init_state(jax.random.key(0), batches[0])
    params, opt, accums = converted(js, tcfg)
    tt = RetrievalTrainer(tcfg, total_steps=total_steps, mode=mode, device="cpu")
    return jt, js, tt, tt.init_state(params, opt_state=opt, accums=accums), batches


SPARSE = [("off", 0), ("rowwise", 0), ("exact", 40)]  # 40 < every batch's valid rows


@pytest.mark.parametrize("sparse,budget", SPARSE, ids=[s for s, _ in SPARSE])
@pytest.mark.parametrize("mode", ["single", "seq2seq", "masked"])
def test_three_steps_match_the_jax_trainer(mode, sparse, budget):
    """Three steps at one interest from the JAX trainer's state, compared
    after steps 1 and 3; then ``evaluate`` on the same batches."""
    cfg = tiny_cfg(sparse, budget, num_query_tokens=1)
    jt, js, tt, ts, batches = start(cfg, mode)
    lr_sum = 0.0
    for step, batch in enumerate(batches, 1):
        lr_sum += tt.optimizer.lr(ts.step)  # the step is the adamw count here
        js, jm, ts, tm = both_step(jt, js, tt, ts, batch, cfg, mode)
        assert_metrics_close(tm, jm)
        if sparse == "exact":
            assert int(tm["sparse_dropped_rows"]) > 0  # the budget cut rows
        if step in (1, 3):
            assert_state_close(ts, js, tt.cfg, lr_sum)
    assert ts.step == 3 == int(js.step)
    jv = jt.evaluate(js, iter(batches))
    tv = tt.evaluate(ts, iter(batches))
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=EVAL_ATOL, err_msg=k)
