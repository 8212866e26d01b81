"""The port's cross-request session cache held against the JAX engine's.

A JAX engine and a port engine serve the same session traffic on the same
weights (the flax tree converted for the port) at float32 on the CPU:
probabilities agree to 1e-5 through refreshes, Δ-appends in every bucket,
folds, re-anchors, both maintenance profiles, the sliding-window trim and
the path without the KV cache. The model-level functions are held against
JAX's directly, and the engine's own invariants are held as the JAX
package's tests hold them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from recommend_tpu.models.ranking import RankingModel as JaxRankingModel
from recommend_tpu.serving.ranking_service import (
    RankingInferenceEngine as JaxEngine,
)
from recommend_tpu_torch.convert import params_from_flax
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from tests.test_torch_ranking import jax_params, make_batch, port_config
from tests.test_torch_serving import MAX_SEQ_LEN, _assert_rows_close, _request

torch.set_num_threads(1)

TOL = 1e-5
SEQS = ("click_seq", "cart_seq", "purchase_seq")


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    return cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN))


def _port(cfg, params, **kwargs):
    tcfg = port_config(cfg)
    return RankingInferenceEngine(
        tcfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg),
        max_seq_len=MAX_SEQ_LEN, device="cpu", **kwargs)


def _pair(cfg, params, **kwargs):
    return JaxEngine(cfg, params, max_seq_len=MAX_SEQ_LEN, **kwargs), _port(
        cfg, params, **kwargs)


@pytest.fixture(scope="module")
def deployment(tiny):
    """slack 8, a re-anchor every 2 folds, the default deployment profile."""
    return _pair(*tiny, slack=8, refresh_every_compactions=2)


def _state(engine, sid):
    sess = engine._sessions[sid]
    return sess["count"], sess["compactions"], bool(sess.get("needs_refresh"))


def _drive(engines, sid, deltas, maintain, seed=0):
    """Send the same session traffic to both engines, Δ items per request on
    the sequences in turn; compare every answer and the session's counts.
    Returns the (count, compactions) states seen."""
    jax_engine, port = engines
    user, seqs, cands = _request(seed)
    rng = np.random.default_rng(seed)
    for engine in engines:
        engine.update_session(sid, seqs)
    _assert_rows_close(port.score_session(sid, user, cands),
                       jax_engine.score_session(sid, user, cands))
    seen = []
    for i, d in enumerate(deltas):
        new = {SEQS[i % 3]: rng.integers(1, 2000, size=d).tolist()}
        got = port.score_session(sid, user, cands, new_items=new)
        _assert_rows_close(got, jax_engine.score_session(sid, user, cands,
                                                         new_items=new))
        assert _state(port, sid) == _state(jax_engine, sid)
        assert port._pending == jax_engine._pending
        if maintain:
            assert port.maintain() == jax_engine.maintain()
        assert port._sessions[sid]["ids"] == jax_engine._sessions[sid]["ids"]
        seen.append(_state(port, sid)[:2])
    return seen


# Δ per request: buckets 1, 2, 4 and 8 (slack 8 takes a bucket of 8 only
# when the buffer is empty, else it folds first)
DEPLOYMENT_DELTAS = (1, 2, 4, 8, 3, 5, 2, 7, 1, 6, 8, 2)


def test_deployment_session_chain_matches_jax(deployment):
    seen = _drive(deployment, "chain", DEPLOYMENT_DELTAS, maintain=True)
    compactions = [c for _, c in seen]
    assert max(compactions) >= 1  # folds happened
    # and re-anchors: the fold count fell back to 0 after a fold
    assert any(a > 0 and b == 0 for a, b in zip(compactions, compactions[1:]))
    jax_engine, port = deployment
    assert port.session_memory_mb() == pytest.approx(jax_engine.session_memory_mb())
    user, _, cands = _request(0)
    np.testing.assert_allclose(
        port.score_session_device("chain", user, cands).numpy(),
        np.asarray(jax_engine.score_session_device("chain", user, cands)),
        atol=TOL, rtol=0)


def test_inline_session_chain_matches_jax(tiny):
    """slack 4: Δs overflow the buffer and fold inline after the fetch; a
    re-anchor every 2 folds runs right after its request."""
    engines = _pair(*tiny, slack=4, refresh_every_compactions=2, profile="inline")
    seen = _drive(engines, "inline", (2, 2, 1, 3, 2, 4, 1, 1, 2, 3), maintain=False)
    assert max(c for _, c in seen) >= 1
    assert engines[1]._pending == set()


def test_sliding_window_trim_matches_jax(deployment):
    """The id window keeps the last max_seq_len items; the cache ages the
    evicted ones out at the re-anchor, after which both engines score the
    trimmed window as score_request does."""
    user, _, cands = _request(5)
    for engine in deployment:
        engine.update_session("trim", {"click_seq": [1, 2, 3, 4, 5, 6, 7]})
        engine.update_session("trim", {"click_seq": [8, 9]})
        assert engine._sessions["trim"]["ids"]["click_seq"] == [2, 3, 4, 5, 6, 7, 8, 9]
    jax_engine, port = deployment
    _assert_rows_close(port.score_session("trim", user, cands),
                       jax_engine.score_session("trim", user, cands))
    for engine in deployment:
        engine.refresh_session("trim")
    got = port.score_session("trim", user, cands)
    _assert_rows_close(got, jax_engine.score_session("trim", user, cands))
    _assert_rows_close(got, port.score_request(
        user, {"click_seq": [2, 3, 4, 5, 6, 7, 8, 9]}, cands), tol=1e-6)


def test_session_without_kv_cache_matches_jax(tiny):
    cfg, _ = tiny
    cfg = dataclasses.replace(cfg, use_kv_cache=False)
    engines = _pair(cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN)))
    user, seqs, cands = _request(6)
    for engine in engines:
        engine.update_session("nokv", seqs)
    jax_engine, port = engines
    _assert_rows_close(port.score_session("nokv", user, cands),
                       jax_engine.score_session("nokv", user, cands))
    new = {"cart_seq": [7, 8, 9]}
    _assert_rows_close(port.score_session("nokv", user, cands, new_items=new),
                       jax_engine.score_session("nokv", user, cands, new_items=new))


def test_session_model_functions_match_jax(tiny):
    """extend_s_cache, compact_s_cache and score_with_cache_ext on the same
    refresh cache: extension buffers, folded cache and logits at 1e-5."""
    cfg, params = tiny
    jm = JaxRankingModel(cfg)
    jax_engine, port = _pair(cfg, params, slack=4)
    model = port.model
    _, seqs, cands = _request(7)
    j_seqs, j_sv = jax_engine.preprocess_sequences(seqs)
    t_seqs, t_sv = port.preprocess_sequences(seqs)
    pad = 2 * 4
    j_cache = jm.apply(params, jm.apply(params, j_seqs, j_sv, method=JaxRankingModel.encode_s),
                       pad, method=JaxRankingModel.pad_s_cache)
    ids = np.array([[11, 12, 13, 0]])
    valid = np.array([[True, True, True, False]])
    j_x = jm.apply(params, "click_seq", jax.numpy.asarray(ids),
                   method=JaxRankingModel.embed_sequence_items)
    j_ek, j_ev = jax_engine._empty_ext()
    j_ek, j_ev, j_cnt = jm.apply(params, j_cache, j_ek, j_ev, 0, j_x,
                                 jax.numpy.asarray(valid),
                                 method=JaxRankingModel.extend_s_cache)
    with torch.inference_mode():
        t_cache = model.pad_s_cache(model.encode_s(t_seqs, t_sv), pad)
        t_x = model.embed_sequence_items("click_seq", torch.from_numpy(ids))
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=TOL, rtol=0)
        t_ek, t_ev = port._empty_ext()
        t_ek, t_ev, t_cnt = model.extend_s_cache(t_cache, t_ek, t_ev, 0, t_x,
                                                 torch.from_numpy(valid))
    assert t_cnt == int(j_cnt) == 3
    for t, j in ((t_ek, j_ek), (t_ev, j_ev)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)
    ns = port._candidate_rows(_request(7)[0], cands)
    j_ns = {k: jax.numpy.asarray(v.numpy()) for k, v in ns.items()}
    j_logits = jm.apply(params, j_cache, j_ek, j_ev, j_cnt, j_ns,
                        method=JaxRankingModel.score_with_cache_ext)
    with torch.inference_mode():
        t_logits = model.score_with_cache_ext(t_cache, t_ek, t_ev, t_cnt, ns)
    for task in j_logits:
        np.testing.assert_allclose(t_logits[task].numpy(), np.asarray(j_logits[task]),
                                   atol=TOL, rtol=0)
    j_fold = jm.apply(params, j_cache, j_ek, j_ev, j_cnt, 1, pad,
                      method=JaxRankingModel.compact_s_cache)
    with torch.inference_mode():
        t_fold = model.compact_s_cache(t_cache, t_ek, t_ev, t_cnt, 1, pad)
    for t_entry, j_entry in zip(t_fold, j_fold):
        assert (t_entry is None) == (j_entry is None)
        for t, j in zip(t_entry or (), j_entry or ()):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The engine's own invariants (tests/test_serving.py's, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port(tiny):
    return _port(*tiny)


def test_refresh_matches_score_request(port):
    user, _, cands = _request(8)
    seqs = {"click_seq": [1, 2, 3, 4], "cart_seq": [5], "purchase_seq": []}
    direct = port.score_request(user, seqs, cands)
    port.update_session("r", {"click_seq": [1, 2]})
    port.update_session("r", {"click_seq": [3, 4], "cart_seq": [5]})
    port.refresh_session("r")  # back to the segmented layout
    _assert_rows_close(port.score_session("r", user, cands), direct, tol=1e-6)


def test_append_batching_is_consistent(port):
    """Appending [a, b] at once equals appending a, then b."""
    user, _, cands = _request(9)
    port.update_session("b1", {"click_seq": [1, 2, 3]})
    port.update_session("b1", {"click_seq": [4, 5]})
    port.update_session("b2", {"click_seq": [1, 2, 3]})
    port.update_session("b2", {"click_seq": [4]})
    port.update_session("b2", {"click_seq": [5]})
    _assert_rows_close(port.score_session("b1", user, cands),
                       port.score_session("b2", user, cands), tol=1e-6)


def test_bad_request_leaves_the_session_unchanged(port):
    port.update_session("v", {"click_seq": [1, 2], "cart_seq": [3]})
    before = {k: list(v) for k, v in port._sessions["v"]["ids"].items()}
    with pytest.raises(KeyError, match="unknown sequence feature"):
        port.update_session("v", {"click_seq": [4], "bogus_seq": [5]})
    assert port._sessions["v"]["ids"] == before
    with pytest.raises((TypeError, ValueError)):
        port.update_session("v", {"click_seq": [6], "cart_seq": ["junk-id"]})
    assert port._sessions["v"]["ids"] == before
    # a rejected first update inserts no half-initialized session
    with pytest.raises(KeyError):
        port.update_session("brand_new", {"bogus_seq": [1, 2]})
    assert "brand_new" not in port._sessions


def test_refresh_after_spare_rows_run_out_does_not_append_twice(port):
    """Once the folds have used every spare row, update_session re-encodes
    from ids that already hold the delta and does not append it again."""
    user, _, cands = _request(10)
    sid = "exhaust"
    port.update_session(sid, {"click_seq": [1, 2, 3]})
    sess = port._sessions[sid]
    for _ in range(port.refresh_every_compactions + 1):
        port.update_session(sid, {"click_seq": [4] * port.slack}, _defer_refresh=True)
    assert sess["compactions"] == port.refresh_every_compactions
    assert port.update_session(sid, {"click_seq": [7] * port.slack},
                               _defer_refresh=True) is False
    sess = port._sessions[sid]
    assert sess["count"] == 0 and sess["compactions"] == 0
    _assert_rows_close(port.score_session(sid, user, cands),
                       port.score_request(user, sess["ids"], cands))
    port._pending.clear()


def test_maintain_is_o_pending(tiny):
    """An idle tick drains the pending set only: with many idle sessions and
    one with deferred work, maintain() examines that one."""
    port = _port(*tiny, slack=4, refresh_every_compactions=1)
    user, _, cands = _request(11)
    for i in range(12):
        port.update_session(f"idle{i}", {"click_seq": [1, 2]})
    assert port._pending == set()
    port.update_session("hot", {"click_seq": [1, 2]})
    port.score_session("hot", user, cands, new_items={"click_seq": [3, 4]})
    port.score_session("hot", user, cands, new_items={"click_seq": [5, 6]})
    port.score_session("hot", user, cands, new_items={"click_seq": [7]})
    assert port._pending == {"hot"} and port._sessions["hot"]["needs_refresh"]
    calls = []
    orig = port._fold_due
    port._fold_due = lambda sess: calls.append(1) or orig(sess)
    assert port.maintain() == 1
    port._fold_due = orig
    assert len(calls) <= 1 and port._pending == set()
    assert port.maintain() == 0
    port._pending.add("ghost")  # evicted after it was queued
    assert port.maintain() == 0 and port._pending == set()


def test_deployment_profile_is_the_default(tiny):
    port = _port(*tiny)
    assert port.auto_maintain is False and port.fold_headroom == port.slack // 2 == 8
    inline = _port(*tiny, profile="inline")
    assert inline.auto_maintain is True and inline.fold_headroom == 0
    with pytest.raises(ValueError):
        _port(*tiny, profile="bogus")


def test_update_session_queues_a_due_fold(tiny):
    """Unlike the JAX engine, whose update_session leaves a near-full buffer
    unqueued until the next scoring request, the port queues
    it for maintain() from update_session itself. The fold is an identity on
    scores."""
    port = _port(*tiny, slack=4)
    user, _, cands = _request(12)
    port.update_session("f", {"click_seq": [1, 2]})
    port.update_session("f", {"click_seq": [3, 4, 5]})  # 3 of 4 rows, headroom 2
    assert port._pending == {"f"}
    before = port.score_session("f", user, cands)
    assert port.maintain() == 1
    assert _state(port, "f") == (0, 1, False)
    _assert_rows_close(port.score_session("f", user, cands), before, tol=1e-6)


def test_extension_buffers_do_not_alias(port):
    port.update_session("alias", {"click_seq": [1, 2]})
    port.update_session("alias", {"click_seq": [3]})
    sess = port._sessions["alias"]
    ek, ev = sess["ext_k"], sess["ext_v"]
    assert ek.untyped_storage().data_ptr() != ev.untyped_storage().data_ptr()
    assert not torch.equal(ek[0, 0, 0], ev[0, 0, 0])
    assert torch.all(ek[:, :, 1:] == 0) and torch.all(ev[:, :, 1:] == 0)


def test_appends_and_a_fold_match_score_request_without_pruning(tiny):
    """Pyramid ratios 1.0 and one behavior sequence: the frozen-window
    forward is the full forward, so refresh, appends, a fold and more
    appends match score_request on the same history."""
    cfg, _ = tiny
    cfg = dataclasses.replace(cfg, pyramid_ratios=(1.0, 1.0),
                              sequence_features=("click_seq",))
    port = _port(cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN)), slack=4)
    user, _, cands = _request(13)
    port.update_session("o", {"click_seq": [1, 2]})
    port.update_session("o", {"click_seq": [3, 4]})
    port.update_session("o", {"click_seq": [5, 6, 7]})  # 2 + 4 > 4: fold first
    assert _state(port, "o")[:2] == (3, 1)
    _assert_rows_close(port.score_session("o", user, cands), port.score_request(
        user, {"click_seq": [1, 2, 3, 4, 5, 6, 7]}, cands))


def test_an_id_outside_its_table_raises_on_the_host(tiny):
    """JAX's lookup (``jnp.take``, mode "fill") reads NaN for an id past its
    table, and a CUDA lookup would fault on the device: the port's engine
    raises on the host, naming the feature, before anything runs, and a
    rejected session update leaves the store as it was."""
    cfg, params = tiny
    jax_engine, port = _pair(cfg, params)
    user, seqs, cands = _request(4)
    bad = [dict(c) for c in cands]
    bad[1]["price_bucket"] = cfg.vocab_size("price_bucket")
    ref = jax_engine.score_request(user, seqs, bad)
    assert np.isnan(ref[1]["ctr"]) and not np.isnan(ref[0]["ctr"])  # the reference
    with pytest.raises(IndexError, match="price_bucket id outside"):
        port.score_request(user, seqs, bad)
    with pytest.raises(IndexError, match="click_seq id outside"):
        port.score_request(user, dict(seqs, click_seq=[1, cfg.vocab_size("item_id")]), cands)
    port.update_session("o", {"click_seq": [1, 2], "cart_seq": [3]})
    before = {k: list(v) for k, v in port._sessions["o"]["ids"].items()}
    with pytest.raises(IndexError, match="cart_seq id outside"):
        port.update_session("o", {"click_seq": [4], "cart_seq": [cfg.vocab_size("item_id")]})
    assert port._sessions["o"]["ids"] == before
    with pytest.raises(IndexError, match="price_bucket id outside"):
        port.score_session("o", user, bad)
    with pytest.raises(IndexError, match="click_seq id outside"):
        port.update_session("fresh", {"click_seq": [-1]})
    assert "fresh" not in port._sessions
    # the rejected calls left the engine serving as the JAX one does
    _assert_rows_close(port.score_request(user, seqs, cands),
                       jax_engine.score_request(user, seqs, cands))
