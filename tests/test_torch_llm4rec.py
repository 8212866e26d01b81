"""The port's LLM4Rec modules held against the JAX package's, on the CPU.

- Semantic distillation: the same numpy teacher vectors through the flax
  model and the port on converted weights (``convert.
  semantic_distill_params_from_flax``): every output, the loss and its
  metrics to 1e-5 of the reference's largest |value|, and the gradient of
  every parameter against ``jax.grad`` to 1e-5 of its tensor's largest
  |value|, all at float32.
- Semantic ids: ``build_semantic_ids`` assignments equal JAX's and the
  centroids agree to 1e-5; ``assign``, ``map_ids`` and
  ``remap_retrieval_data`` equal JAX's array for array; three
  ``RetrievalTrainer`` steps over the semantic vocabulary against the JAX
  trainer at the tolerances of ``tests/test_torch_retrieval_training_steps.py``
  (one interest).
- The intent cache and the prompts: ``tests/test_llm4rec.py``'s cases run
  on the port, and both packages render the same prompt and return the
  same corrected labels for the same stub LLM.

The intents' way into the ranking model is held in
``tests/test_torch_llm4rec_ranking.py``.
"""

import dataclasses
import hashlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import retrieval_batches as j_retrieval_batches
from recommend_tpu.data.synthetic import make_retrieval_data as j_retrieval_data
from recommend_tpu.llm4rec import prompts as jprompts
from recommend_tpu.llm4rec import semantic_distill as jdistill
from recommend_tpu.llm4rec import semantic_ids as jsids
from recommend_tpu.training.trainer import RetrievalTrainer as JaxRetrievalTrainer
from recommend_tpu_torch.convert import (
    init_semantic_distill_params,
    semantic_distill_params_from_flax,
)
from recommend_tpu_torch.data import synthetic as tsynthetic
from recommend_tpu_torch.llm4rec import (
    INTENT_AXES,
    IntentCache,
    IntentPromptGenerator,
    SemanticDistillConfig,
    SemanticDistillModel,
    build_semantic_ids,
    intent_specs,
    remap_retrieval_data,
    semantic_distill_loss,
)
from recommend_tpu_torch.training.trainer import RetrievalTrainer
from tests.test_torch_retrieval_training_steps import (
    assert_metrics_close,
    assert_state_close,
    both_step,
    converted,
    port_cfg,
    tiny_cfg,
)

torch.set_num_threads(1)

TOL = 1e-5  # of the reference's largest |value|, float32


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


# ---------------------------------------------------------------------------
# semantic distillation
# ---------------------------------------------------------------------------

DISTILL = dict(teacher_dim=48, hidden_dim=32, num_heads=4, head_dim=8)


@pytest.fixture(scope="module")
def distill():
    jcfg = jdistill.SemanticDistillConfig(**DISTILL)
    tcfg = SemanticDistillConfig(**DISTILL)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(16, DISTILL["teacher_dim"])).astype(np.float32)
    it = rng.normal(size=(16, DISTILL["teacher_dim"])).astype(np.float32)
    jm = jdistill.SemanticDistillModel(jcfg)
    jp = jm.init(jax.random.key(0), jnp.asarray(u), jnp.asarray(it))
    model = SemanticDistillModel(tcfg)
    model.load_state_dict(semantic_distill_params_from_flax(_np_tree(jp), tcfg))
    return jcfg, tcfg, jm, jp, model, u, it


def test_config_matches_field_for_field():
    assert [f.name for f in dataclasses.fields(SemanticDistillConfig)] == [
        f.name for f in dataclasses.fields(jdistill.SemanticDistillConfig)]
    assert dataclasses.asdict(SemanticDistillConfig()) == dataclasses.asdict(
        jdistill.SemanticDistillConfig())
    assert SemanticDistillConfig().out_dim == jdistill.SemanticDistillConfig().out_dim == 128


def test_distill_outputs_loss_and_metrics_match_flax(distill):
    jcfg, tcfg, jm, jp, model, u, it = distill
    want = jm.apply(jp, jnp.asarray(u), jnp.asarray(it))
    with torch.no_grad():
        got = model(torch.from_numpy(u), torch.from_numpy(it))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    jl, jmetrics = jdistill.semantic_distill_loss(jcfg, want, jnp.asarray(u), jnp.asarray(it))
    tl, tmetrics = semantic_distill_loss(tcfg, got, torch.from_numpy(u), torch.from_numpy(it))
    assert set(tmetrics) == set(jmetrics)
    _close(tl, jl, "loss")
    for k in jmetrics:
        _close(tmetrics[k], jmetrics[k], k)
    with torch.no_grad():
        _close(model.user_embedding(torch.from_numpy(u)),
               jm.apply(jp, jnp.asarray(u), method=jm.user_embedding), "user_embedding")
        _close(model.item_embedding(torch.from_numpy(it)),
               jm.apply(jp, jnp.asarray(it), method=jm.item_embedding), "item_embedding")
    np.testing.assert_allclose(np.linalg.norm(got["user_vec"].numpy(), axis=-1), 1.0, rtol=1e-5)


def test_distill_gradients_match_jax_grad(distill):
    jcfg, tcfg, jm, jp, model, u, it = distill
    ju, jit_ = jnp.asarray(u), jnp.asarray(it)
    jg = jax.grad(lambda p: jdistill.semantic_distill_loss(
        jcfg, jm.apply(p, ju, jit_), ju, jit_)[0])(jp)
    want = semantic_distill_params_from_flax(_np_tree(jg), tcfg)
    model.zero_grad()
    tu, tit = torch.from_numpy(u), torch.from_numpy(it)
    semantic_distill_loss(tcfg, model(tu, tit), tu, tit)[0].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in want.items():
        _close(grads[k], g.numpy(), k)


def test_init_draws_flax_shapes_from_a_seed():
    cfg = SemanticDistillConfig(**DISTILL)
    a = init_semantic_distill_params(cfg, seed=3, device="cpu")
    b = init_semantic_distill_params(cfg, seed=3, device="cpu")
    c = init_semantic_distill_params(cfg, seed=4, device="cpu")
    flax = jdistill.SemanticDistillModel(jdistill.SemanticDistillConfig(**DISTILL)).init(
        jax.random.key(0), jnp.zeros((2, 48)), jnp.zeros((2, 48)))
    ref = semantic_distill_params_from_flax(_np_tree(flax), cfg)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in ref.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["user_tower.enc1.weight"], c["user_tower.enc1.weight"])
    for k, v in a.items():
        if k.endswith(".bias"):
            assert not v.any(), k
        else:  # lecun normal: the std of flax's draw of the same tensor
            assert abs(float(v.std()) / float(ref[k].std()) - 1) < 0.15, k
    SemanticDistillModel(cfg).load_state_dict(a)


# ---------------------------------------------------------------------------
# semantic ids
# ---------------------------------------------------------------------------

def _clustered(seed=0, k=4, v=200, d=16):
    """``tests/test_llm4rec.py``'s well-separated clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 10
    true = rng.integers(0, k, v)
    return centers[true] + rng.normal(size=(v, d)) * 0.05, true


SID_CASES = {
    "separated": lambda: (_clustered()[0], dict(n_clusters=4, iters=8, seed=2, chunk=128)),
    "overlapping": lambda: (np.random.default_rng(1).normal(size=(300, 8)).astype(np.float32),
                            dict(n_clusters=16, iters=4, seed=0, chunk=128)),
    "defaults": lambda: (np.random.default_rng(2).normal(size=(1500, 8)).astype(np.float32),
                         dict()),  # 1024 clusters, 10 iterations, seed 0, chunk 65536
}


@pytest.mark.parametrize("case", sorted(SID_CASES))
def test_build_semantic_ids_assign_and_map_match_jax(case):
    emb, kw = SID_CASES[case]()
    jm = jsids.build_semantic_ids(emb, **kw)
    tm = build_semantic_ids(emb, **kw)
    assert tm.item_to_sid.dtype == np.int32 and tm.n_clusters == jm.n_clusters
    np.testing.assert_array_equal(tm.item_to_sid, jm.item_to_sid)
    _close(tm.centroids, jm.centroids, "centroids")
    cold = np.asarray(emb[:7], np.float32) + 0.01
    got = tm.assign(cold)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.assign(jnp.asarray(cold))))
    v = len(emb)
    ids = np.array([[0, v, 3], [v - 1, v + 5, 2]])  # the padding sentinel and an OOV id
    np.testing.assert_array_equal(tm.map_ids(ids), jm.map_ids(ids))
    assert tm.map_ids(ids)[0, 1] == tm.n_clusters


def test_semantic_ids_keep_the_clusters_apart():
    """``tests/test_llm4rec.py``'s purity case on the port."""
    emb, true = _clustered()
    sids = build_semantic_ids(emb, n_clusters=4, iters=8, seed=2, chunk=128).item_to_sid
    mapped = [set(sids[true == c].tolist()) for c in range(4)]
    assert all(len(s) == 1 for s in mapped) and len(set().union(*mapped)) == 4


def _semantic_data(cfg, sentinel: bool):
    """(JAX data, the port's copy of it, item embeddings), the first user's
    first two ids set to the padding sentinel V and an OOV id."""
    jd = j_retrieval_data(cfg, num_users=20, num_videos=200, seed=0)
    td = tsynthetic.make_retrieval_data(port_cfg(cfg), num_users=20, num_videos=200, seed=0)
    if sentinel:
        for d in (jd, td):
            u0 = d.user_sequences[0]
            u0["video_id"] = np.asarray(u0["video_id"]).copy()
            u0["video_id"][:2] = (200, 205)
    emb = np.random.default_rng(1).normal(size=(200, 8)).astype(np.float32)
    return jd, td, emb


@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_remap_retrieval_data_matches_jax(sentinel):
    cfg = tiny_cfg()
    jd, td, emb = _semantic_data(cfg, sentinel)
    jm = jsids.build_semantic_ids(emb, n_clusters=16, iters=4, seed=0, chunk=128)
    tm = build_semantic_ids(emb, n_clusters=16, iters=4, seed=0, chunk=128)
    jr, tr = jsids.remap_retrieval_data(jd, jm), remap_retrieval_data(td, tm)
    assert type(tr) is tsynthetic.SyntheticRetrievalData
    assert tr.num_videos == 16 and tr.popularity.sum() == td.popularity.sum()
    np.testing.assert_array_equal(tr.popularity, jr.popularity)
    assert tr.popularity.dtype == jr.popularity.dtype
    assert list(tr.video_features) == list(jr.video_features)
    for k in jr.video_features:
        np.testing.assert_array_equal(tr.video_features[k], jr.video_features[k])
        assert tr.video_features[k].dtype == jr.video_features[k].dtype, k
    assert len(tr.user_sequences) == len(jr.user_sequences)
    for a, b in zip(tr.user_sequences, jr.user_sequences):
        assert list(a) == list(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    if sentinel:
        s0 = tr.user_sequences[0]
        assert (s0["video_id"][:2] == 16).all()
        assert all((s0[k][:2] == 0).all() for k in tr.video_features if k in s0)


def test_next_semantic_id_training_matches_the_jax_trainer():
    """Three single-mode steps at one interest over the semantic vocabulary
    (16 clusters + the padding id) on the remapped data, from the JAX
    trainer's state; compared after steps 1 and 3, then ``evaluate``."""
    jd, _, emb = _semantic_data(tiny_cfg(), sentinel=False)
    sdata = jsids.remap_retrieval_data(jd, jsids.build_semantic_ids(
        emb, n_clusters=16, iters=4, seed=0, chunk=128))
    cfg = tiny_cfg(num_query_tokens=1, video_vocab_size=17)
    batches = list(j_retrieval_batches(sdata, cfg, batch_size=8, seed=0, num_epochs=1,
                                       use_native=False))[:3]
    assert len(batches) == 3 and all(b["target"]["video_id"].max() < 16 for b in batches)
    tcfg = port_cfg(cfg)
    jt = JaxRetrievalTrainer(cfg, total_steps=10)
    js = jt.init_state(jax.random.key(0), batches[0])
    params, opt, accums = converted(js, tcfg)
    tt = RetrievalTrainer(tcfg, total_steps=10, device="cpu")
    ts = tt.init_state(params, opt_state=opt, accums=accums)
    lr_sum = 0.0
    for step, batch in enumerate(batches, 1):
        lr_sum += tt.optimizer.lr(ts.step)
        js, jm, ts, tm = both_step(jt, js, tt, ts, batch, cfg, "single")
        assert_metrics_close(tm, jm)
        if step in (1, 3):
            assert_state_close(ts, js, tcfg, lr_sum)
    jv, tv = jt.evaluate(js, iter(batches)), tt.evaluate(ts, iter(batches))
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the intent cache and the prompts (tests/test_llm4rec.py's cases)
# ---------------------------------------------------------------------------

def test_intent_cache_hit_miss_precompute():
    dim = 8
    calls = []

    def gen(payload):
        calls.append(payload)
        return np.full(dim, float(len(calls)))

    cache = IntentCache(gen, default_intent=np.zeros(dim), async_updates=False)
    np.testing.assert_array_equal(cache.get("u1"), np.zeros(dim))
    assert cache.stats["misses"] == 1
    v = cache.get("u2", payload={"history": [1, 2]})
    assert v[0] == 1.0
    np.testing.assert_array_equal(cache.get("u2"), v)
    assert cache.stats["hits"] == 1
    cache.precompute({"u3": "p3", "u4": "p4"})
    assert len(cache) == 3 and cache.stats["generated"] == 3
    out = cache.batch_get(["u2", "u3", "u4", "ghost"])
    assert out.shape == (4, dim)
    np.testing.assert_array_equal(out[3], np.zeros(dim))


def test_intent_cache_lru_eviction():
    cache = IntentCache(lambda p: np.ones(2), np.zeros(2), capacity=2, async_updates=False)
    for u in ("a", "b", "c"):
        cache.get(u, payload=u)
    assert len(cache) == 2
    assert cache.get("a")[0] == 0.0  # evicted -> default


def test_intent_cache_refreshes_stale_entries():
    """An entry older than ``max_age_s`` counts a refresh: with a payload
    it is generated again, without one the stale intent is returned."""
    n = iter(range(1, 100))
    cache = IntentCache(lambda p: np.full(2, float(next(n))), np.zeros(2), max_age_s=0.0,
                        async_updates=False)
    cache.precompute({"u": None})
    time.sleep(0.01)
    assert cache.get("u")[0] == 1.0 and cache.stats["refreshes"] == 1
    assert cache.get("u", payload="p")[0] == 2.0 and cache.stats["refreshes"] == 2
    assert cache.stats["generated"] == 2 and cache.stats["hits"] == 0


def test_intent_cache_async_miss_generates_on_a_thread():
    """An async miss returns the default at once and enqueues the user
    once; the intent lands when the generator returns."""
    release = threading.Event()

    def gen(payload):
        assert release.wait(timeout=10)
        return np.full(3, 7.0)

    cache = IntentCache(gen, np.zeros(3), async_updates=True)
    assert (cache.get("u", payload="p") == 0).all()
    assert (cache.get("u", payload="p") == 0).all()  # pending: not enqueued twice
    assert cache._pending == {"u"}
    release.set()
    deadline = time.time() + 10
    while "u" in cache._pending and time.time() < deadline:
        time.sleep(0.005)
    assert not cache._pending and cache.stats["generated"] == 1
    assert (cache.get("u") == 7.0).all() and cache.stats["hits"] == 1


def test_prompt_spec_build_and_roundtrip():
    spec = intent_specs(axis_vocab={"category": ("games", "music", "news")})["global_intent"]
    prompt = spec.build({"behavior_items": ["Item A — intro", "Item B"]})
    assert "Role:" in prompt and "Task:" in prompt
    assert "behavior_items: Item A — intro; Item B" in prompt
    assert "category: <category> (one of: games, music, news)" in prompt
    reply = ("category: music\ntopic: pop idols\ncontent: interviews\n"
             "content_form: short video\nextra: ignored")
    parsed = spec.parse(reply)
    assert parsed == {"category": "music", "topic": "pop idols",
                      "content": "interviews", "content_form": "short video"}
    assert spec.correct(parsed)["category"] == "music"


def test_prompt_spec_missing_input_raises():
    with pytest.raises(KeyError):
        intent_specs()["item_attributes"].build({"title": "t", "intro": "i"})


def test_prompt_output_correction_snaps_and_defaults():
    specs = intent_specs(axis_vocab={"category": ("games", "music")}, num_semantic_ids=8)
    fixed = specs["global_intent"].correct({"category": "mostly Music videos", "topic": "x"})
    assert fixed["category"] == "music" and fixed["topic"] == "x"
    assert fixed["content"] == "unknown" and fixed["content_form"] == "unknown"
    sid = specs["next_semantic_id"]
    assert sid.correct({"semantic_id": "5"})["semantic_id"] == "5"
    assert sid.correct({"semantic_id": "banana"})["semantic_id"] == "0"
    assert sid.correct({})["semantic_id"] == "0"


def test_intent_prompt_generator_feeds_intent_cache():
    vocab = {a: ("alpha", "beta") for a in INTENT_AXES}

    def llm(prompt):
        assert "Role:" in prompt
        return "\n".join(f"{a}: beta" for a in INTENT_AXES)

    def axis_encoder(axis, label):
        return np.full(4, 1.0 if label == "beta" else 0.0, np.float32)

    gen = IntentPromptGenerator(llm, axis_encoder, axis_vocab=vocab)
    cache = IntentCache(gen, default_intent=np.zeros(16, np.float32), async_updates=False)
    intent = cache.get("u1", payload={"behavior_items": ["Item A"]})
    assert intent.shape == (16,) and np.all(intent == 1.0)
    assert cache.stats["generated"] == 1
    assert np.all(cache.get("u1") == 1.0) and cache.stats["hits"] == 1


AXIS_VOCAB = {"category": ("games", "music", "news"), "topic": ("pop", "rock", "sports"),
              "content_form": ("short video", "live")}
PAYLOADS = [
    {"behavior_items": ["Item A — intro", "Item B"], "title": "T", "intro": "I",
     "summary": "S", "semantic_id_sequence": [3, 1, 4]},
    {"behavior_items": ("Concert", "Match highlights", "News"), "title": "t2", "intro": "",
     "summary": "s2", "semantic_id_sequence": (7,)},
]


def stub_llm(prompt: str) -> str:
    """A deterministic stand-in LLM: replies from a hash of its prompt,
    sometimes off-vocabulary, sometimes with a line missing."""
    h = hashlib.sha256(prompt.encode()).digest()
    words = ("Music", "rock and pop", "games!", "news", "3", "banana", "live stream")
    lines = [f"{f}: {words[h[i] % len(words)]}"
             for i, f in enumerate(("category", "topic", "content", "content_form",
                                    "next_title", "semantic_id"))
             if h[i + 8] % 5]
    return "\n".join(lines)


@pytest.mark.parametrize("name", ["item_attributes", "next_item", "global_intent",
                                  "item_semantic_id", "next_semantic_id"])
def test_both_packages_render_the_same_prompt_and_labels(name):
    jspec = jprompts.intent_specs(AXIS_VOCAB, num_semantic_ids=8)[name]
    tspec = intent_specs(AXIS_VOCAB, num_semantic_ids=8)[name]
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for payload in PAYLOADS:
        assert tspec.build(payload) == jspec.build(payload)
        assert tspec(stub_llm, payload) == jspec(stub_llm, payload)
    assert INTENT_AXES == jprompts.INTENT_AXES


def test_both_packages_generate_the_same_intent():
    enc = lambda axis, label: np.frombuffer(
        hashlib.sha256(f"{axis}={label}".encode()).digest()[:16], np.uint8).astype(np.float32)
    jgen = jprompts.IntentPromptGenerator(stub_llm, enc, AXIS_VOCAB)
    tgen = IntentPromptGenerator(stub_llm, enc, AXIS_VOCAB)
    for payload in PAYLOADS:
        np.testing.assert_array_equal(tgen(payload), jgen(payload))
