"""The semantic features of the LLM4Rec intents in the port's ranking
trainer, held against the JAX package on the CPU.

An intent vector enters the ranking model as a float ``non_seq`` feature
(``cfg.semantic_features``), which the tokenizer concatenates to the NS
embeddings. The port's trainer must hand it over as float32, as the JAX
trainer does (it once cast every ``non_seq`` entry to int64, truncating the
intent). One ``RankingTrainer`` step of ``RankingModel`` and of
``DINRankingModel`` at ``ranking_small`` (float32, dropout 0) with a
``user_intent`` feature against the JAX trainer's step from the same
converted parameters: loss rtol 1e-5, grad norm rtol 1e-4, parameters atol
1e-5 / rtol 1e-4, as ``tests/test_torch_training.py``. And the intent moves
the port's logits (``tests/test_llm4rec.py``'s flow case).
"""

import jax
import numpy as np
import pytest
import torch

from recommend_tpu.config import get_config as j_get_config
from recommend_tpu.data.pipeline import ranking_batches as j_ranking_batches
from recommend_tpu.data.synthetic import make_ranking_data as j_ranking_data
from recommend_tpu.models.din import DINRankingModel as JaxDIN
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxRankingTrainer
from recommend_tpu_torch.convert import din_params_from_flax, init_params, params_from_flax
from recommend_tpu_torch.models.din import DINRankingModel
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_ranking_model import tiny_ranking_cfg
from tests.test_torch_ranking import port_config

torch.set_num_threads(1)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)



INTENT_DIM = 16


def _intent_batch(cfg):
    data = j_ranking_data(cfg, num_samples=8, max_seq_per_feature=8, seed=0)
    batch = next(j_ranking_batches(data, cfg, batch_size=4, num_epochs=1))
    batch["non_seq"]["user_intent"] = np.random.default_rng(1).normal(
        size=(4, INTENT_DIM)).astype(np.float32)
    return batch


@pytest.mark.parametrize("din", [False, True], ids=["onetrans", "din"])
def test_a_step_with_a_float_intent_feature_matches_the_jax_trainer(din):
    """One step at ``ranking_small`` (float32, dropout 0) with
    ``semantic_features=(("user_intent", 16),)`` from the JAX trainer's
    converted parameters: the port must hand the tokenizer the float intent
    as JAX does (it truncated it to int64 before)."""
    cfg = j_get_config("ranking_small", use_mixed_precision=False, dropout_rate=0.0,
                       semantic_features=(("user_intent", INTENT_DIM),))
    tcfg = port_config(cfg)
    batch = _intent_batch(cfg)
    jt = JaxRankingTrainer(cfg, model=JaxDIN(cfg) if din else None)
    js = jt.init_state(jax.random.key(0), batch)
    convert = din_params_from_flax if din else params_from_flax
    tt = RankingTrainer(tcfg, model=DINRankingModel(tcfg) if din else None, device="cpu")
    ts = tt.init_state(convert(_np_tree(js.params), tcfg))
    put = tt._put_batch(batch)
    js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
    ts, tm = tt._train_step(ts, put)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for k, v in convert(_np_tree(js.params), tcfg).items():
        if not torch.isnan(v).any():  # absent from the flax tree
            np.testing.assert_allclose(ts.params[k].detach().numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
    assert put["non_seq"]["user_intent"].dtype == torch.float32
    assert torch.equal(put["non_seq"]["user_intent"],
                       torch.from_numpy(batch["non_seq"]["user_intent"]))
    assert all(put["non_seq"][f].dtype == torch.long for f in tcfg.non_seq_features)


def test_the_intent_moves_the_logits():
    """``tests/test_llm4rec.py``'s semantic-feature flow on the port: the
    intent feeds the NS tokens, so shifting it moves the predictions."""
    cfg = port_config(tiny_ranking_cfg(semantic_features=(("user_intent", INTENT_DIM),)))
    batch = _intent_batch(tiny_ranking_cfg(semantic_features=(("user_intent", INTENT_DIM),)))
    model = RankingModel(cfg)
    model.load_state_dict(init_params(cfg, seed=0, device="cpu"))
    put = RankingTrainer(cfg, device="cpu")._put_batch(batch)
    args = (put["non_seq"], put["sequences"], put["seq_valid"])
    with torch.no_grad():
        out1 = model(*args)
        out2 = model(dict(put["non_seq"], user_intent=put["non_seq"]["user_intent"] + 1.0),
                     *args[1:])
    assert float((out1["ctr"] - out2["ctr"]).abs().max()) > 1e-6
