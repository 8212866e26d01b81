"""The port's initializers draw every tensor at the scale the JAX package's
flax initializers draw it: ``convert.init_params`` for OneTrans (at the
replica track's S depth, pyramid and 12 NS tokens, narrowed) and for DIN,
and ``convert.init_retrieval_params`` for the retrieval tower. The draws
differ (each package has its own generator), so each tensor is held by its
statistics: the standard deviation within 10% of JAX's and the mean within
a tenth of it, for every tensor of at least 1,024 elements, and constant
tensors (zero biases, unit norm scales) equal.

flax's ``lecun_normal`` counts every axis but the last two into the fan-in,
so a stacked [n_ns, in, out] weight has fan-in n_ns · in: the port once
drew the NS stacks at fan-in ``in``, √12 wider than JAX at 12 NS tokens,
which none of the step comparisons could see (they start from JAX's
converted params).
"""

import jax
import numpy as np
import pytest
import torch

import quality_torch as q
from recommend_tpu.config import get_config as jget_config
from recommend_tpu.data.pipeline import ranking_batches, retrieval_batches
from recommend_tpu.data.synthetic import make_retrieval_data
from recommend_tpu.models.din import DINRankingModel as JaxDIN
from recommend_tpu.models.retrieval import RetrievalTower as JaxTower
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.convert import (din_params_from_flax, init_params,
                                         init_retrieval_params, params_from_flax,
                                         retrieval_params_from_flax)
from recommend_tpu_torch.models.din import DINRankingModel
from tests.test_torch_quality_onetrans import jax_base

torch.set_num_threads(1)

# the track's S geometry (6 layers, pyramid 0.5 .. 0.03, 2 heads, 12 NS
# tokens) at d 64
NARROW = dict(embed_dim=64, num_heads=2, ffn_dim=256, feature_embed_dim=32,
              seq_item_feature_dim=32, batch_size=32)
MIN_NUMEL = 1024


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ranking(din: bool):
    jcfg = jget_config("ranking_base", **{**jax_base("small", "S", False), **NARROW})
    tcfg = RankingConfig.from_dict(jcfg.to_dict())
    tr, _, _, _ = q.make_replica(tcfg, "small", 0, "v2", 0.05, None)
    batch = next(iter(ranking_batches(tr, jcfg, 32, seed=0, num_epochs=1)))
    if din:
        js = JaxTrainer(jcfg, model=JaxDIN(jcfg)).init_state(jax.random.key(0), batch)
        with torch.device("meta"):
            model = DINRankingModel(tcfg)
        return (din_params_from_flax(_np(js.params), tcfg),
                init_params(tcfg, seed=0, device="cpu", model=model))
    js = JaxTrainer(jcfg).init_state(jax.random.key(0), batch)
    return params_from_flax(_np(js.params), tcfg), init_params(tcfg, seed=0, device="cpu")


def _retrieval():
    jcfg = jget_config("retrieval_small", embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
                       max_seq_len=32, compression_schedule=((16, 4), (16, 1)),
                       compute_dtype="float32", video_vocab_size=4096)
    tcfg = RetrievalConfig.from_dict(jcfg.to_dict())
    data = make_retrieval_data(jcfg, num_users=20, num_videos=2000, seed=0)
    b = next(iter(retrieval_batches(data, jcfg, batch_size=4, num_epochs=1)))
    tree = JaxTower(jcfg).init(jax.random.key(0), {k: jax.numpy.asarray(v)
                                                   for k, v in b["history"].items()},
                               jax.numpy.asarray(b["history_valid"]))
    return retrieval_params_from_flax(_np(tree), tcfg), init_retrieval_params(
        tcfg, seed=0, device="cpu")


@pytest.mark.parametrize("model", ["onetrans", "din", "retrieval"])
def test_each_tensor_is_drawn_at_the_jax_scale(model):
    ref, got = _retrieval() if model == "retrieval" else _ranking(model == "din")
    assert set(got) == set(ref)
    compared, off = 0, []
    for name, r in ref.items():
        r, g = r.double(), got[name].double()
        assert g.shape == r.shape, name
        if not torch.isfinite(r).all():
            # a pyramid layer's S weights no S token reaches: flax creates
            # none, and the conversion fills them with NaN
            continue
        if r.std() == 0 if r.numel() > 1 else True:
            torch.testing.assert_close(g, r, rtol=0, atol=0, msg=name)
            continue
        if r.numel() < MIN_NUMEL:
            continue
        compared += 1
        rs, gs = r.std().item(), g.std().item()
        if abs(gs - rs) > 0.1 * rs or abs(g.mean().item() - r.mean().item()) > 0.1 * rs:
            off.append((name, tuple(r.shape), round(gs / rs, 3)))
    assert not off, f"std ratio port / JAX: {off}"
    assert compared >= 10
