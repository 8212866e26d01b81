"""An index whose corpus is assigned rather than built searches it, as the
JAX index does.

``examples/flagship_serving_bench.py:113-120`` (and its port) build one flat
index, then give each int8 variant the flat index's ``item_embeddings`` and
its int8 copy by assignment. JAX bounds k by the corpus the index holds
(``recommend_tpu/serving/retrieval_service.py:318-319``); the port once
bounded it by a count that only ``build`` set, so such an index searched a
top 0. Here the same assigned arrays go into both packages' indexes at
``retrieval_small`` widths (float32), and ``search`` and the recommender
are held against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu import config as jconfig
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu.models.retrieval import RetrievalTower as JTower
from recommend_tpu.serving.retrieval_service import RealTimeRecommender as JRecommender
from recommend_tpu.serving.retrieval_service import RetrievalIndex as JIndex
from recommend_tpu.serving.retrieval_service import _quantize as j_quantize
from recommend_tpu_torch.convert import retrieval_params_from_flax
from recommend_tpu_torch.ops.topk import quantize_corpus
from recommend_tpu_torch.serving.retrieval_service import RealTimeRecommender, RetrievalIndex
from tests.test_torch_retrieval import first_batch, jax_in, port_cfg

torch.set_num_threads(1)

SCORE_TOL = 1e-5  # relative: float32 sums of the same products in another order
VARIANTS = {"flat": {}, "int8": {"quantize": "int8"},
            "int8_approx": {"quantize": "int8", "approx_recall": 0.99}}


@pytest.fixture(scope="module")
def setup():
    """``retrieval_small`` at float32 over a 300-item corpus: (JAX config,
    port config, flax model, flax params, port state dict, the corpus
    embedded once by the JAX index, 4 users' interests)."""
    cfg = jconfig.get_config("retrieval_small", video_vocab_size=300, compute_dtype="float32",
                             dropout_rate=0.0, top_k=20)
    model = JTower(cfg)
    batch = first_batch(cfg)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), *jax_in(batch)))
    built = JIndex(cfg, model, params)
    built.build(j_data(cfg, num_users=10, num_videos=300, seed=0).corpus_features())
    items = np.array(built.item_embeddings)  # writable: the port takes it as a tensor
    ints = np.asarray(jax.jit(model.apply)(params, *jax_in(batch)))
    tcfg = port_cfg(cfg)
    return cfg, tcfg, model, params, retrieval_params_from_flax(params, tcfg), items, ints


def assigned(setup, kw):
    """Both packages' indexes with the corpus (and its int8 copy) assigned."""
    cfg, tcfg, model, params, sd, items, _ = setup
    j = JIndex(cfg, model, params, **kw)
    j.item_embeddings = jnp.asarray(items)
    t = RetrievalIndex(tcfg, sd, device="cpu", **kw)
    t.item_embeddings = torch.as_tensor(items)
    if kw.get("quantize"):
        j.q_items, j.q_scales = j_quantize(j.item_embeddings)
        t.q_items, t.q_scales = quantize_corpus(t.item_embeddings)
    return j, t


@pytest.mark.parametrize("name", list(VARIANTS))
def test_an_assigned_index_searches_the_top_k_of_the_jax_index(setup, name):
    j, t = assigned(setup, VARIANTS[name])
    ints = setup[6]
    assert t.num_items == len(setup[5])
    for k in (10, None, len(setup[5]) + 5):  # 10, cfg.top_k, past the corpus
        ts, ti = t.search(torch.as_tensor(ints), k)
        js, ji = j.search(jnp.asarray(ints), k)
        want = min(k or setup[0].top_k, len(setup[5]))
        assert ti.shape == (len(ints), want)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=SCORE_TOL,
                                   atol=SCORE_TOL * float(np.abs(np.asarray(js)).max()))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_the_recommender_serves_from_an_assigned_index(setup, name):
    cfg, tcfg, model, params, sd, items, _ = setup
    j, t = assigned(setup, VARIANTS[name])
    jr = JRecommender(cfg, model, params, j)
    tr = RealTimeRecommender(tcfg, sd, t, device="cpu")
    for vid in (3, 17, 42, 99):
        item = {"video_id": vid, "category": 1 + vid % 7, "tag": 2 + vid % 11,
                "duration": 30.0, "timestamp": 1_700_000_000 + vid}
        jr.add_interaction("u", item)
        tr.add_interaction("u", item)
    got, ref = tr.get_recommendations("u", top_k=10), jr.get_recommendations("u", top_k=10)
    assert len(got) == 10
    assert [r["video_id"] for r in got] == [r["video_id"] for r in ref]
    assert not {3, 17, 42, 99} & {r["video_id"] for r in got}
    got, ref = tr.similar_to(5, top_k=4), jr.similar_to(5, top_k=4)
    assert [r["video_id"] for r in got] == [r["video_id"] for r in ref] and len(got) == 4


def test_the_count_follows_the_held_corpus(setup):
    """Before a corpus the count is 0; then it follows each assignment."""
    _, tcfg, _, _, sd, items, _ = setup
    t = RetrievalIndex(tcfg, sd, device="cpu")
    assert t.num_items == 0
    t.item_embeddings = torch.as_tensor(items[:120])
    assert t.num_items == 120
    t.item_embeddings = torch.as_tensor(items)
    assert t.num_items == len(items)
