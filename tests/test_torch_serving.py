"""The port's ranking inference engine held against the JAX engine.

Both engines serve the same requests on the same weights (the flax tree
converted for the port) at float32 on the CPU; per-candidate probabilities
agree to 1e-5 on every request path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from recommend_tpu.serving.ranking_service import (
    RankingInferenceEngine as JaxEngine,
)
from recommend_tpu_torch.convert import params_from_flax
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from tests.test_torch_ranking import jax_params, make_batch, port_config

torch.set_num_threads(1)

TOL = 1e-5
MAX_SEQ_LEN = 8


def _engines(cfg, params):
    port = RankingInferenceEngine(
        port_config(cfg),
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), port_config(cfg)),
        max_seq_len=MAX_SEQ_LEN, device="cpu",
    )
    return JaxEngine(cfg, params, max_seq_len=MAX_SEQ_LEN), port


@pytest.fixture(scope="module")
def engines():
    cfg = _tiny_cfg()
    return _engines(cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN)))


def _request(seed=0):
    rng = np.random.default_rng(seed)
    user = {"user_id": int(rng.integers(0, 1000)), "age_bucket": 2, "gender": 1,
            "city": 3, "hour": 12, "weekday": 3, "device": 1}
    # click_seq longer than the window (truncated to the most recent),
    # cart_seq short (left-padded), purchase_seq empty
    seqs = {"click_seq": rng.integers(1, 2000, size=11).tolist(),
            "cart_seq": [5, 6], "purchase_seq": []}
    cands = [{"item_id": int(rng.integers(0, 2000)), "category": int(rng.integers(0, 50)),
              "brand": int(rng.integers(0, 100)), "price_bucket": 3}
             for _ in range(5)]
    return user, seqs, cands


def _assert_rows_close(a, b, tol=TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for t in x:
            assert abs(x[t] - y[t]) <= tol, (t, x[t], y[t])


def test_preprocess_matches(engines):
    jax_engine, port = engines
    _, seqs, _ = _request()
    j_ids, j_valid = jax_engine.preprocess_sequences(seqs)
    t_ids, t_valid = port.preprocess_sequences(seqs)
    for sf in jax_engine.cfg.sequence_features:
        assert np.array_equal(t_ids[sf].numpy(), np.asarray(j_ids[sf]))
        assert np.array_equal(t_valid[sf].numpy(), np.asarray(j_valid[sf]))
    assert t_ids["click_seq"][0, -1].item() == seqs["click_seq"][-1]


def test_single_inference_matches(engines):
    jax_engine, port = engines
    user, seqs, cands = _request(1)
    features = dict(user, **cands[0])
    _assert_rows_close([port.single_inference(features, seqs)],
                       [jax_engine.single_inference(features, seqs)])


def test_batch_inference_matches(engines):
    jax_engine, port = engines
    rows = []
    for s in range(3):
        user, seqs, cands = _request(s)
        rows.append((dict(user, **cands[s]), seqs))
    _assert_rows_close(port.batch_inference(rows), jax_engine.batch_inference(rows))


def test_score_request_matches(engines):
    jax_engine, port = engines
    user, seqs, cands = _request(2)
    got = port.score_request(user, seqs, cands)
    _assert_rows_close(got, jax_engine.score_request(user, seqs, cands))
    # the KV-cached request reproduces the full forward per candidate
    _assert_rows_close(got, [port.single_inference(dict(user, **c), seqs)
                             for c in cands])
    dev = port.score_request_device(user, seqs, cands)
    assert tuple(dev.shape) == (len(port.cfg.tasks), 8)  # bucketed 5 -> 8
    np.testing.assert_allclose(
        dev.numpy(), np.asarray(jax_engine.score_request_device(user, seqs, cands)),
        atol=TOL, rtol=0)


def test_score_request_without_kv_cache_matches():
    cfg = dataclasses.replace(_tiny_cfg(), use_kv_cache=False)
    jax_engine, port = _engines(cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN)))
    user, seqs, cands = _request(3)
    _assert_rows_close(port.score_request(user, seqs, cands),
                       jax_engine.score_request(user, seqs, cands))


def test_stats_and_warmup_match():
    """The same calls give the same counts, warmup included: both engines'
    warmups run the batch forward, the KV-cached request and the same
    session ladder (an append per Δ bucket, then one fold and a re-anchor),
    and leave no session behind."""
    cfg = _tiny_cfg()
    jax_engine, port = _engines(cfg, jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN)))
    user, seqs, cands = _request(4)
    for engine in (jax_engine, port):
        engine.score_request(user, seqs, cands)
        engine.single_inference(dict(user, **cands[0]), seqs)
        engine.batch_inference([(dict(user, **cands[1]), seqs)])
    j, t = jax_engine.stats(), port.stats()
    assert set(t) == set(j)
    for key in ("total", "success", "failure", "success_rate"):
        assert t[key] == j[key]
    assert t["total"] == 3 and t["latency_ms_p99"] >= t["latency_ms_p50"] > 0
    for engine in (jax_engine, port):
        engine.warmup(n_candidates=3)
    assert port.stats()["total"] == jax_engine.stats()["total"] > 5
    assert not port._sessions and not port._pending


def test_failed_request_is_recorded(engines):
    _, port = engines
    before = port.stats()["failure"]
    with pytest.raises(IndexError):  # an id past the user_id table
        port.single_inference({"user_id": 10**6}, {"click_seq": [1]})
    assert port.stats()["failure"] == before + 1
