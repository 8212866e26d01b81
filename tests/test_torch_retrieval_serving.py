"""The port's retrieval serving path held against the JAX package on the CPU,
at float32, on the same weights (``convert.retrieval_params_from_flax``) and
the same seeded inputs:

- ``quantize_corpus``: the int8 rows and the scales bit-equal;
- ``score_items``, ``topk_retrieval`` and ``topk_retrieval_quantized``: the
  same ids, scores within ``SCORE_TOL`` relative (float32 sums in another
  order), also when the scan walks the corpus in chunks;
- ``kmeans_corpus`` and ``build_ivf`` on ``tests/test_ivf.py``'s clustered
  corpus: the same assignments and ``bucket_ids`` (forced capacity too),
  centroids within ``SCORE_TOL``; two builds bit-equal;
- ``ivf_search`` and ``ivf_search_interests`` on a JAX-built index converted
  to tensors;
- every ``RetrievalIndex`` path of ``tests/test_serving.py`` (search, IVF,
  int8, incremental updates, refresh, similar items), the
  ``RealTimeRecommender`` flow, and the ``RetrievalEvaluator`` metrics.

Ties follow ``lax.top_k``: a corpus of duplicated rows (and an IVF index
with duplicated centroids) gives the same ids in the same order as JAX, also
when the scan's chunks split the tied rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import retrieval_batches as j_batches
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu.evaluation.retrieval_eval import RetrievalEvaluator as JEvaluator
from recommend_tpu.ops import ivf as jivf
from recommend_tpu.ops import topk as jtopk
from recommend_tpu.serving.retrieval_service import RealTimeRecommender as JRecommender
from recommend_tpu.serving.retrieval_service import RetrievalIndex as JIndex
from recommend_tpu_torch.convert import retrieval_params_from_flax
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
from recommend_tpu_torch.ops import ivf as tivf
from recommend_tpu_torch.ops import topk as ttopk
from recommend_tpu_torch.serving.retrieval_service import RealTimeRecommender, RetrievalIndex
from tests.test_ivf import _corpus
from tests.test_torch_retrieval import first_batch, jax_in, port_cfg, tiny_cfg

torch.set_num_threads(1)

SCORE_TOL = 1e-5  # relative: float32 sums of the same products in another order
# int8 scales: the jitted JAX quantization divides by 127 as a multiplication
# by its reciprocal, one float32 ulp away (the eager one, held bit for bit
# below, divides)
SCALE_RTOL = 1e-6


def scores_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=SCORE_TOL,
                               atol=SCORE_TOL * np.abs(ref[finite]).max())


def same_topk(got, ref):
    (gs, gi), (rs, ri) = got, ref
    scores_close(gs, rs)
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(ri))


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, flax model, flax params, port state dict,
    data): ``tests/test_serving.py``'s retrieval setup."""
    from recommend_tpu.models.retrieval import RetrievalTower as JTower

    cfg = tiny_cfg()
    data = j_data(cfg, num_users=10, num_videos=200, seed=0)
    model = JTower(cfg)
    batch = first_batch(cfg)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), *jax_in(batch)))
    tcfg = port_cfg(cfg)
    return cfg, tcfg, model, params, retrieval_params_from_flax(params, tcfg), data


def interests(seed, b=2, k=4, d=32):
    return np.random.default_rng(seed).normal(size=(b, k, d)).astype(np.float32)


def both_indexes(setup, **kw):
    cfg, tcfg, model, params, sd, data = setup
    j = JIndex(cfg, model, params, embed_batch=64, **kw)
    t = RetrievalIndex(tcfg, sd, embed_batch=64, device="cpu", **kw)
    corpus = data.corpus_features()
    j.build(corpus)
    t.build(corpus)
    return j, t


# -- ops/topk ----------------------------------------------------------------


def test_quantize_corpus_is_bit_equal():
    items = _corpus(500, 32, seed=1)
    items[3] = 0.0  # an all-zero row: scale 0
    jq, js = jtopk.quantize_corpus(jnp.asarray(items))
    tq, ts = ttopk.quantize_corpus(torch.as_tensor(items))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("chunk_rows", [None, 37], ids=["one_chunk", "chunked"])
def test_topk_scans_match(chunk_rows):
    items = _corpus(600, 32, seed=2)
    q = interests(3, b=5)
    scores_close(ttopk.score_items(torch.as_tensor(q), torch.as_tensor(items)).numpy(),
                 jtopk.score_items(jnp.asarray(q), jnp.asarray(items)))
    same_topk(ttopk.topk_retrieval(torch.as_tensor(q), torch.as_tensor(items), 25, chunk_rows),
              jtopk.topk_retrieval(jnp.asarray(q), jnp.asarray(items), 25))
    # [B, D] interests and k above one chunk's rows
    same_topk(ttopk.topk_retrieval(torch.as_tensor(q[:, 0]), torch.as_tensor(items), 50,
                                   chunk_rows),
              jtopk.topk_retrieval(jnp.asarray(q[:, 0]), jnp.asarray(items), 50))
    jq, js = jtopk.quantize_corpus(jnp.asarray(items))
    tq, ts = ttopk.quantize_corpus(torch.as_tensor(items))
    ref = jtopk.topk_retrieval_quantized(jnp.asarray(q), jq, js, 25)
    same_topk(ttopk.topk_retrieval_quantized(torch.as_tensor(q), tq, ts, 25,
                                             chunk_rows=chunk_rows), ref)
    # recall_target runs the exact top k
    same_topk(ttopk.topk_retrieval_quantized(torch.as_tensor(q), tq, ts, 25, 0.99,
                                             chunk_rows=chunk_rows), ref)


def test_tied_scores_come_back_lower_id_first():
    items = np.full((10, 4), 0.5, np.float32)
    items[7] = 2.0
    items[[8, 0, 5]] = 1.0
    s, i = ttopk.topk_retrieval(torch.ones(1, 4), torch.as_tensor(items), 4, chunk_rows=3)
    assert i.tolist() == [[7, 0, 5, 8]]
    assert s.tolist() == [[8.0, 4.0, 4.0, 4.0]]


def _duplicated_corpus(n=400, distinct=30, d=16, seed=0):
    """Rows drawn from ``distinct`` rows: every score ties with others."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(distinct, d)).astype(np.float32)
    return base[rng.integers(0, distinct, n)], rng.normal(size=(3, 4, d)).astype(np.float32)


@pytest.mark.parametrize("chunk_rows", [None, 7, 50], ids=["one_chunk", "chunks_of_7", "chunks_of_50"])
def test_ties_follow_lax_top_k(chunk_rows):
    """Duplicated rows tie at every place, the k-th too: the flat and int8
    scans return JAX's ids in JAX's order (the lowest tied ids, ascending)."""
    items, q = _duplicated_corpus()
    js, ji = jtopk.topk_retrieval(jnp.asarray(q), jnp.asarray(items), 25)
    ts, ti = ttopk.topk_retrieval(torch.as_tensor(q), torch.as_tensor(items), 25,
                                  chunk_rows=chunk_rows)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scores_close(ts.numpy(), np.asarray(js))
    jq, jsc = jtopk.quantize_corpus(jnp.asarray(items))
    tq, tsc = ttopk.quantize_corpus(torch.as_tensor(items))
    js, ji = jtopk.topk_retrieval_quantized(jnp.asarray(q), jq, jsc, 25)
    ts, ti = ttopk.topk_retrieval_quantized(torch.as_tensor(q), tq, tsc, 25,
                                            chunk_rows=chunk_rows)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_chunked_selection_equals_lax_top_k():
    """The scan's selection alone, on one precomputed score matrix sliced
    into chunks (so that equal scores stay equal whatever the chunk):
    heavy ties, -inf, every k and chunk size drawn at random, against
    ``lax.top_k`` (scores and ids, in order)."""
    rng = np.random.default_rng(5)
    for _ in range(60):
        n = int(rng.integers(1, 200))
        vals = np.round(rng.normal(size=(3, n)), int(rng.integers(0, 2))).astype(np.float32)
        vals[:, rng.integers(0, n, n // 4)] = -np.inf
        k, chunk = int(rng.integers(1, n + 1)), int(rng.integers(1, n + 5))
        js, ji = jax.lax.top_k(jnp.asarray(vals), k)
        scores = torch.as_tensor(vals)
        ts, ti = ttopk._scan_topk(n, lambda r0, r1: scores[:, r0:r1], k, chunk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"{n} {k} {chunk}")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ivf_ties_follow_lax_top_k():
    """Two clusters with one centroid, and one row stored under a high id in
    the first bucket and a low id in the second: the probes tie (the lower
    cluster first) and so do the items, which JAX orders by their slot in
    the gathered list, not by id."""
    rng = np.random.default_rng(1)
    d, cap = 8, 4
    rows = rng.normal(size=(6, d)).astype(np.float32)
    centroids = rng.normal(size=(3, d)).astype(np.float32)
    centroids[1] = centroids[0]
    bucket_ids = np.array([[9, 11, 12, -1], [3, 4, 13, -1], [5, 6, 7, 8]], np.int32)
    # id 9 (bucket 0) and id 3 (bucket 1) hold one row; 11/4 another
    embs = np.stack([rows[[0, 1, 2, 0]], rows[[0, 1, 3, 0]], rows[[4, 5, 4, 5]]])
    j = jivf.IVFIndex(jnp.asarray(centroids), jnp.asarray(bucket_ids), jnp.asarray(embs))
    t = _converted(j)
    q = np.concatenate([centroids[:1] + 0.01 * rng.normal(size=(1, d)),
                        rows[:2]]).astype(np.float32)
    for nprobe, k in ((2, 6), (3, 10), (1, 3)):
        js, ji = jivf.ivf_search(j, jnp.asarray(q), k, nprobe)
        ts, ti = tivf.ivf_search(t, torch.as_tensor(q), k, nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"nprobe {nprobe}")
        scores_close(ts.numpy(), np.asarray(js))
    assert ti.numpy()[0, 0] == 9  # the higher id, first in the gathered list


# -- ops/ivf -----------------------------------------------------------------


@pytest.mark.parametrize("capacity", [None, 100], ids=["largest_cluster", "forced"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_build_ivf_matches(capacity, quantize):
    items = _corpus()
    j = jivf.build_ivf(items, n_clusters=16, iters=5, capacity=capacity, quantize=quantize)
    t = tivf.build_ivf(torch.as_tensor(items), n_clusters=16, iters=5, capacity=capacity,
                       quantize=quantize)
    np.testing.assert_array_equal(t.bucket_ids.numpy(), np.asarray(j.bucket_ids))
    scores_close(t.centroids.numpy(), np.asarray(j.centroids))
    np.testing.assert_array_equal(t.bucket_embs.numpy(), np.asarray(j.bucket_embs))
    if quantize:
        np.testing.assert_allclose(t.bucket_scales.numpy(), np.asarray(j.bucket_scales),
                                   rtol=SCALE_RTOL)
    if capacity is not None:
        assert (np.asarray(j.bucket_ids) >= 0).sum() < len(items)  # some items dropped
    again = tivf.build_ivf(torch.as_tensor(items), n_clusters=16, iters=5, capacity=capacity,
                           quantize=quantize)
    for a, b in zip(t, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_kmeans_corpus_matches():
    items = _corpus(1500, 16, clusters=8, seed=4)
    jc, ja = jivf.kmeans_corpus(items, 8, iters=4, seed=2)
    tc, ta = tivf.kmeans_corpus(torch.as_tensor(items), 8, iters=4, seed=2)
    assert ta.dtype == np.int32
    np.testing.assert_array_equal(ta, ja)
    scores_close(tc.numpy(), np.asarray(jc))


def _converted(j):
    return tivf.IVFIndex(*[None if x is None else torch.as_tensor(np.array(x)) for x in j])


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_ivf_search_matches_on_a_converted_jax_index(quantize):
    items = _corpus()
    j = jivf.build_ivf(items, n_clusters=16, iters=5, quantize=quantize)
    t = _converted(j)
    q = _corpus(8, 32, seed=3)
    for nprobe in (3, 16):
        ref = jivf.ivf_search(j, jnp.asarray(q), 10, nprobe)
        same_topk(tivf.ivf_search(t, torch.as_tensor(q), 10, nprobe), ref)
        same_topk(tivf.ivf_search(t, torch.as_tensor(q), 10, nprobe, query_chunk=3), ref)
    qi = q.reshape(2, 4, 32)
    for nprobe in (2, 16):
        same_topk(tivf.ivf_search_interests(t, torch.as_tensor(qi), 10, nprobe),
                  jivf.ivf_search_interests(j, jnp.asarray(qi), 10, nprobe))
    # fewer reachable items than k: -inf and -1 past them (the JAX function
    # raises there: it reshapes to k columns)
    s, i = tivf.ivf_search_interests(t, torch.as_tensor(qi), 1000, 1)
    assert s.shape == i.shape == (2, 1000)
    n = (i >= 0).sum(axis=1)
    assert 0 < n.min() and n.max() < 1000
    for row, found in zip(range(2), n):
        assert np.isfinite(s[row, :found]).all() and np.isneginf(s[row, found:]).all()
        assert (i[row, found:] == -1).all() and len(set(i[row, :found])) == found


def test_full_probe_equals_the_flat_scan():
    items = _corpus()
    t = tivf.build_ivf(torch.as_tensor(items), n_clusters=16, iters=5)
    q = torch.as_tensor(_corpus(8, 32, seed=3).reshape(2, 4, 32))
    s, i = tivf.ivf_search_interests(t, q, 10, nprobe=16)
    rs, ri = ttopk.topk_retrieval(q, torch.as_tensor(items), 10)
    same_topk((s, i), (rs.numpy(), ri.numpy()))


# -- serving/retrieval_service ----------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}, {"quantize": "int8", "approx_recall": 0.99},
                                {"index_type": "ivf", "ivf_clusters": 8, "ivf_nprobe": 3,
                                 "ivf_iters": 4},
                                {"index_type": "ivf", "ivf_clusters": 8, "ivf_nprobe": 8,
                                 "quantize": "int8"}],
                         ids=["flat", "int8", "int8_approx", "ivf", "ivf_int8"])
def test_index_search_matches(setup, kw):
    j, t = both_indexes(setup, **kw)
    scores_close(t.item_embeddings.numpy(), np.asarray(j.item_embeddings))
    q = interests(0)
    same_topk(t.search(q, top_k=10), j.search(jnp.asarray(q), top_k=10))
    same_topk(t.search(torch.as_tensor(q)), j.search(jnp.asarray(q)))  # cfg.top_k
    same_topk(t.similar_items([3, 17], top_k=5), j.similar_items([3, 17], top_k=5))
    np.testing.assert_array_equal(t.fetch_items([3, 17]).numpy(),
                                  t.item_embeddings.numpy()[[3, 17]])


def _changed(corpus, lo, hi, shift, cfg):
    upd = {k: np.array(v[lo:hi]) for k, v in corpus.items()}
    upd["category"] = (upd["category"] + shift) % cfg.category_vocab_size
    return upd


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}], ids=["flat", "int8"])
def test_update_items_matches(setup, kw):
    cfg = setup[0]
    j, t = both_indexes(setup, **kw)
    corpus = setup[5].corpus_features()
    for idx in (j, t):
        idx.update_items(_changed(corpus, 10, 15, 1, cfg))
    scores_close(t.item_embeddings.numpy(), np.asarray(j.item_embeddings))
    if kw:
        np.testing.assert_array_equal(t.q_items.numpy(), np.asarray(j.q_items))
        np.testing.assert_allclose(t.q_scales.numpy(), np.asarray(j.q_scales), rtol=SCALE_RTOL)
    # append two new ids, one duplicated (its last row wins)
    v = len(corpus["video_id"])
    new = {k: np.array(x[[0, 1, 1]]) for k, x in corpus.items()}
    new["video_id"] = np.array([v, v + 1, v + 1])
    new["category"] = np.array([4, 5, 6])
    for idx in (j, t):
        idx.update_items(new)
    assert t.item_embeddings.shape[0] == v + 2
    scores_close(t.item_embeddings.numpy(), np.asarray(j.item_embeddings))
    if kw:
        np.testing.assert_array_equal(t.q_items.numpy(), np.asarray(j.q_items))
    for key in corpus:
        np.testing.assert_array_equal(t._last_corpus[key], j._last_corpus[key])
    same_topk(t.search(interests(1)), j.search(jnp.asarray(interests(1))))


def test_update_items_rejects_gapped_append(setup):
    _, t = both_indexes(setup)
    corpus = setup[5].corpus_features()
    upd = {k: np.array(v[:1]) for k, v in corpus.items()}
    upd["video_id"] = np.array([len(corpus["video_id"]) + 3])
    with pytest.raises(ValueError, match="contiguous"):
        t.update_items(upd)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_ivf_update_items_in_place_matches(setup, quantize):
    cfg = setup[0]
    j, t = both_indexes(setup, index_type="ivf", ivf_clusters=8, ivf_nprobe=8,
                        quantize=quantize)
    corpus = setup[5].corpus_features()
    embs, scales = t.ivf_index.bucket_embs, t.ivf_index.bucket_scales
    for idx in (j, t):
        idx.update_items(_changed(corpus, 3, 9, 7, cfg))
    assert t.ivf_index.bucket_embs is embs and t.ivf_index.bucket_scales is scales  # in place
    got, ref = t.ivf_index.bucket_embs.numpy(), np.asarray(j.ivf_index.bucket_embs)
    if quantize:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(t.ivf_index.bucket_scales.numpy(),
                                   np.asarray(j.ivf_index.bucket_scales), rtol=SCALE_RTOL)
    else:
        scores_close(got, ref)
    same_topk(t.search(interests(2)), j.search(jnp.asarray(interests(2))))
    new = {k: np.array(v[:1]) for k, v in corpus.items()}
    new["video_id"] = np.array([len(corpus["video_id"])])
    with pytest.raises(ValueError, match="requires build"):
        t.update_items(new)


def test_refresh_copies_into_the_tower_and_keeps_appended_items(setup):
    cfg, tcfg, model, params, sd, data = setup
    # the tower holds the state dict's own tensors, which refresh writes
    # into: give it a copy, so the other tests keep their weights
    setup = setup[:4] + ({k: v.clone() for k, v in sd.items()}, data)
    j, t = both_indexes(setup, quantize="int8")
    corpus = data.corpus_features()
    v = len(corpus["video_id"])
    new = {k: np.array(x[:3]) for k, x in corpus.items()}
    new["video_id"] = np.arange(v, v + 3)
    for idx in (j, t):
        idx.update_items(new)
    own = {k: x.data_ptr() for k, x in t.model.state_dict().items()}
    jnew = jax.tree_util.tree_map(lambda p: p * 1.1, params)
    j.refresh(jnew)
    t.refresh(retrieval_params_from_flax(jnew, tcfg))
    assert {k: x.data_ptr() for k, x in t.model.state_dict().items()} == own
    assert t.item_embeddings.shape[0] == v + 3
    scores_close(t.item_embeddings.numpy(), np.asarray(j.item_embeddings))
    np.testing.assert_array_equal(t.q_items.numpy(), np.asarray(j.q_items))
    bad = retrieval_params_from_flax(jnew, tcfg)
    bad["final_norm.scale"] = bad["final_norm.scale"][:-1]
    before = t.item_embeddings.clone()
    with pytest.raises(ValueError, match="final_norm.scale"):
        t.refresh(bad)
    del bad["final_norm.scale"]
    with pytest.raises(ValueError, match="names differ"):
        t.refresh(bad)
    assert torch.equal(t.item_embeddings, before)


def test_recommender_flow_matches(setup):
    cfg, tcfg, model, params, sd, data = setup
    j, t = both_indexes(setup)
    jr = JRecommender(cfg, model, params, j)
    tr = RealTimeRecommender(tcfg, sd, t, device="cpu")
    seq = data.user_sequences[2]
    for n in range(len(seq["video_id"])):
        item = {k: seq[k][n].item() for k in seq}
        jr.add_interaction("u1", item)
        tr.add_interaction("u1", item)
    jr.add_interaction("u2", {"video_id": 3, "category": 1, "tag": 2, "duration": 30.0,
                              "timestamp": 1_700_000_003})
    tr.add_interaction("u2", {"video_id": 3, "category": 1, "tag": 2, "duration": 30.0,
                              "timestamp": 1_700_000_003})
    seen = set(seq["video_id"][-cfg.max_seq_len:].tolist())  # the session window
    for user, kw in (("u1", {}), ("u1", {"exclude_seen": False}),
                     ("u1", {"mean_pool_interests": True}), ("u2", {}), ("nobody", {})):
        got = tr.get_recommendations(user, top_k=8, **kw)
        ref = jr.get_recommendations(user, top_k=8, **kw)
        assert [r["video_id"] for r in got] == [r["video_id"] for r in ref]
        scores_close([r["score"] for r in got], [r["score"] for r in ref])
    assert not seen & {r["video_id"] for r in tr.get_recommendations("u1", top_k=50)}
    got, ref = tr.similar_to(3, top_k=4), jr.similar_to(3, top_k=4)
    assert [r["video_id"] for r in got] == [r["video_id"] for r in ref]
    assert all(r["video_id"] != 3 for r in got)
    scores_close(tr.user_interests("u1").numpy(), np.asarray(jr.user_interests("u1")))
    stats = tr.stats()
    assert stats["requests"] == 7 and stats["latency_ms_p50"] > 0
    assert RealTimeRecommender(tcfg, sd, t, device="cpu").stats() == {"requests": 0}


def test_recommender_keeps_its_own_weights(setup):
    """A recommender built from the state dict its index was built from
    copies it: writing the source tensors, or refreshing the index, leaves
    the recommender's interests as they were (JAX: each holder keeps its
    own ``params``)."""
    cfg, tcfg, model, params, sd, data = setup
    src = {k: v.clone() for k, v in sd.items()}
    index = RetrievalIndex(tcfg, src, embed_batch=64, device="cpu")
    index.build(data.corpus_features())
    rec = RealTimeRecommender(tcfg, src, index, device="cpu")
    seq = data.user_sequences[1]
    for n in range(len(seq["video_id"])):
        rec.add_interaction("u", {k: seq[k][n].item() for k in seq})
    before = rec.user_interests("u").clone()
    ranked = [r["video_id"] for r in rec.get_recommendations("u", top_k=8)]
    for v in src.values():
        v.mul_(1.5)
    assert torch.equal(rec.user_interests("u"), before)
    assert [r["video_id"] for r in rec.get_recommendations("u", top_k=8)] == ranked
    index.refresh(src)
    assert torch.equal(rec.user_interests("u"), before)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in
                   zip(rec.model.state_dict().values(), index.model.state_dict().values()))


def test_benchmark_latency_copies_the_batch_once(setup, monkeypatch):
    """The batch goes to the device once, before the warm-up; the timed
    calls copy nothing (JAX's ``benchmark_latency`` puts it once too)."""
    cfg, tcfg, model, params, sd, data = setup
    batch = first_batch(cfg, bs=4)
    ev = RetrievalEvaluator(tcfg, sd, device="cpu")
    ev.index.build(data.corpus_features())
    puts = []
    put = ev._put
    monkeypatch.setattr(ev, "_put", lambda features: puts.append(1) or put(features))
    lat = ev.benchmark_latency(batch, n_iters=5, warmup=2)
    assert lat["batch_size"] == 4
    once = len(puts)
    ev.benchmark_latency(batch, n_iters=9, warmup=4)
    assert 0 < once == len(puts) - once  # the same copies, whatever the call count


def test_evaluator_matches(setup, tmp_path):
    cfg, tcfg, model, params, sd, _ = setup
    data = j_data(cfg, num_users=30, num_videos=200, seed=5)
    batches = list(j_batches(data, cfg, batch_size=8, seed=0, num_epochs=1,
                             use_native=False))[:6]
    batches[-1]["num_real"] = 5
    j = JEvaluator(cfg, model, params)
    t = RetrievalEvaluator(tcfg, sd, device="cpu")
    got = t.evaluate_retrieval(data, batches, ks=(1, 5, 10, 50))
    ref = j.evaluate_retrieval(data, batches, ks=(1, 5, 10, 50))
    assert got.keys() == ref.keys() and got == pytest.approx(ref, rel=1e-6)
    got = t.evaluate_classification(data, batches[:3], num_negatives=20, seed=1)
    ref = j.evaluate_classification(data, batches[:3], num_negatives=20, seed=1)
    assert got == pytest.approx(ref, rel=1e-5)
    lat = t.benchmark_latency(batches[0], n_iters=3, warmup=1)
    assert lat["batch_size"] == 8 and lat["latency_ms_p50"] > 0
    t.save_results(got, str(tmp_path / "out" / "r.json"))
    assert (tmp_path / "out" / "r.json").exists()
    # the port's batches feed it as the JAX ones do
    tb = list(retrieval_batches(data, tcfg, batch_size=8, seed=0, num_epochs=1))[:6]
    tb[-1]["num_real"] = 5
    assert t.evaluate_retrieval(data, tb, ks=(1, 5, 10, 50)) == pytest.approx(
        j.evaluate_retrieval(data, batches, ks=(1, 5, 10, 50)), rel=1e-6)
