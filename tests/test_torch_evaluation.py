"""The port's metrics and offline evaluation held against the JAX package on
the CPU, at float32.

- every metric of ``training/metrics.py`` on the same numpy inputs (1e-6;
  the numpy AUCs are the same code and agree exactly);
- ``RankingEvaluator.evaluate``, ``ab_test`` and ``feature_importance`` on
  the same weights (the flax tree converted) and batches (1e-5);
- ``ranking_model_flops``, ``param_count`` and ``get_model_info`` equal to
  the JAX package's;
- ``mfu`` against a hand computation with the H100 row, an unknown card
  raising, and the device rule of the new entry points.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.data.synthetic import make_ranking_data
from recommend_tpu.evaluation import benchmark as jbench
from recommend_tpu.evaluation import ranking_eval as jeval
from recommend_tpu.models.ranking import RankingModel as JaxRankingModel
from recommend_tpu.training import metrics as jmetrics
from recommend_tpu_torch.convert import init_params, params_from_flax
from recommend_tpu_torch.evaluation import benchmark as tbench
from recommend_tpu_torch.evaluation import ranking_eval as teval
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.training import metrics as tmetrics
from tests.test_ranking_model import tiny_ranking_cfg
from tests.test_torch_ranking import jax_args, port_config

torch.set_num_threads(1)

ATOL = 1e-5
SEQ_LEN = 16  # every layer keeps S rows: the flax tree has every parameter


def _scores(seed=0, b=12, n=60):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, n)).astype(np.float32)
    scores[0, :5] = scores[0, 7]  # ties with the true item of row 0
    return scores, rng.integers(0, n, size=b)


RETRIEVAL = [
    ("hit_rate_at_k", lambda m, s, i: m.hit_rate_at_k(s, i, 10)),
    ("ndcg_at_k", lambda m, s, i: m.ndcg_at_k(s, i, 10)),
    ("mrr", lambda m, s, i: m.mrr(s, i)),
]


@pytest.mark.parametrize("name,fn", RETRIEVAL, ids=[r[0] for r in RETRIEVAL])
def test_retrieval_metrics_match_jax(name, fn):
    scores, true_idx = _scores()
    true_idx[0] = 7
    got = fn(tmetrics, torch.from_numpy(scores), torch.from_numpy(true_idx))
    want = fn(jmetrics, jnp.asarray(scores), jnp.asarray(true_idx))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_retrieval_metric_suite_matches_jax():
    scores, true_idx = _scores(1)
    got = tmetrics.retrieval_metric_suite(torch.from_numpy(scores), torch.from_numpy(true_idx))
    want = jmetrics.retrieval_metric_suite(jnp.asarray(scores), jnp.asarray(true_idx))
    assert set(got) == set(want) and "recall@100" not in got  # k past the columns
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, err_msg=k)


def _probs_labels(seed=0, n=300):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    probs = np.clip(rng.normal(0.4 + 0.2 * labels, 0.2), 0, 1).astype(np.float32)
    probs[:40] = np.round(probs[:40], 1)  # ties
    groups = rng.integers(0, 12, size=n)
    return probs, labels, groups


@pytest.mark.parametrize("weighted", [True, False])
def test_exact_and_grouped_auc_equal_jax(weighted):
    probs, labels, groups = _probs_labels()
    assert tmetrics.exact_auc(probs, labels) == jmetrics.exact_auc(probs, labels)
    assert np.isnan(tmetrics.exact_auc(probs, np.zeros_like(labels)))
    assert (tmetrics.grouped_auc(probs, labels, groups, weighted)
            == jmetrics.grouped_auc(probs, labels, groups, weighted))


def test_streaming_auc_reads_one_at_perfect_separation():
    """The trapezoids are summed in float64: in float32 their sum reads a
    unit in the last place either side of 1 at perfect separation (here
    0.99999994 at 54 and 56 examples), and above 1 no AUC is."""
    init, update, compute = tmetrics.streaming_auc()
    for n in range(37, 77):
        probs = torch.rand(n, generator=torch.Generator().manual_seed(n - 37))
        auc = compute(update(init(), probs, (probs > 0.5).float()))
        assert auc.dtype == torch.float32 and auc.item() == 1.0, (n, auc.item())


def test_binary_classification_suite_matches_jax():
    probs, labels, _ = _probs_labels(1)
    probs[0], probs[1] = 0.0, 1.0  # clipped inside logloss
    got = tmetrics.binary_classification_suite(torch.from_numpy(probs),
                                               torch.from_numpy(labels))
    want = jmetrics.binary_classification_suite(jnp.asarray(probs), jnp.asarray(labels))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("labels", [[1.0, 1.0, 1.0, 0.0, 0.0, 0.0], [1.0] * 6, [0.0] * 6])
def test_best_f1_operating_point_equals_jax(labels):
    probs = np.array([0.9, 0.8, 0.4, 0.3, 0.2, 0.1])
    labels = np.array(labels)
    assert (teval._best_f1_operating_point(probs, labels)
            == jeval._best_f1_operating_point(probs, labels))


@pytest.fixture(scope="module")
def evaluators():
    """The JAX evaluator on a flax tree and the port's on its conversion."""
    cfg = tiny_ranking_cfg(batch_size=16)
    data = make_ranking_data(cfg, num_samples=200, max_seq_per_feature=SEQ_LEN, seed=0)
    batch = next(iter(ranking_batches(data, cfg, batch_size=16, num_epochs=1)))
    jm = JaxRankingModel(cfg)
    params = jax.jit(jm.init)(jax.random.key(0), *jax_args(batch))
    tcfg = port_config(cfg)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    with torch.device("meta"):
        model = RankingModel(tcfg)
    return (cfg, data, jeval.RankingEvaluator(cfg, jm, params),
            teval.RankingEvaluator(tcfg, model, sd, device="cpu"), params, sd)


def _batches(cfg, data, seed, n):
    return list(itertools.islice(ranking_batches(data, cfg, batch_size=16, seed=seed), n))


def _assert_reports_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "throughput_samples_per_s":
            continue  # a time, and in ab_test a ratio of two times
        if isinstance(v, dict):
            _assert_reports_close(got[k], v)
        elif isinstance(v, (str, bool, np.bool_)):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, atol=ATOL, err_msg=k)


def test_evaluate_matches_jax(evaluators):
    cfg, data, jev, tev, _, _ = evaluators
    batches = _batches(cfg, data, 1, 4)
    got, want = tev.evaluate(iter(batches)), jev.evaluate(iter(batches))
    _assert_reports_close(got, want)
    assert got["num_samples"] == 64 and got["throughput_samples_per_s"] > 0
    for t in cfg.tasks:
        assert f"{t}_uauc" in got and f"{t}_auc_streaming" in got


def test_ab_test_matches_jax(evaluators):
    cfg, data, jev, tev, _, _ = evaluators
    arms = _batches(cfg, data, 2, 3), _batches(cfg, data, 3, 3)
    got = tev.ab_test(iter(arms[0]), iter(arms[1]), bootstrap_samples=50)
    want = jev.ab_test(iter(arms[0]), iter(arms[1]), bootstrap_samples=50)
    _assert_reports_close(got, want)
    same = tev.ab_test(iter(arms[0]), iter(arms[0]), bootstrap_samples=50)
    assert not same["auc_lift_significant_95"] and abs(same["positive_rate_z_score"]) < 1e-6


def test_feature_importance_matches_jax(evaluators, tmp_path, monkeypatch):
    cfg, data, jev, tev, _, _ = evaluators
    batches = _batches(cfg, data, 4, 2)
    feats = ["price_bucket", "gender", "user_id"]
    got = tev.feature_importance(batches, features=feats)
    want = jev.feature_importance(batches, features=feats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    # the report and its charts
    report = dict(tev.evaluate(iter(batches)), feature_importance=got)
    path = str(tmp_path / "out" / "report.json")
    tev.save_report(report, path)
    assert json.load(open(path))["ctr_auc"] == report["ctr_auc"]
    written = tev.save_charts(report, str(tmp_path / "charts"))
    assert len(written) == len(cfg.tasks) + 1
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert tev.save_charts(report, str(tmp_path / "none")) == []


def test_flops_param_count_and_model_info_equal_jax(evaluators):
    cfg, _, _, _, params, sd = evaluators
    tcfg = port_config(cfg)
    for s_len in (50, 350):
        for training in (False, True):
            assert (tbench.ranking_model_flops(tcfg, s_len, training)
                    == jbench.ranking_model_flops(cfg, s_len, training))
    assert not any(torch.isnan(v).any() for v in sd.values())
    jm = JaxRankingModel(cfg)
    with torch.device("meta"):
        model = RankingModel(tcfg)
    assert model.param_count(sd) == jm.param_count(params)
    assert model.get_model_info(sd) == jm.get_model_info(params)
    assert model.get_model_info(sd, s_len=50) == jm.get_model_info(params, s_len=50)


def test_mfu_uses_the_h100_row_and_an_unknown_card_raises():
    cfg = port_config(tiny_ranking_cfg())
    f = tbench.ranking_model_flops(cfg, s_len=100, training=True)
    got = tbench.mfu(5000.0, f, "NVIDIA H100 80GB HBM3")
    assert got == 100.0 * 5000.0 * f / 989.4e12
    assert tbench.mfu(5000.0, f, "NVIDIA H100 80GB HBM3", n_chips=4) == got / 4
    for card in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e"):
        with pytest.raises(KeyError, match="no peak"):
            tbench.mfu(5000.0, f, card)


def test_new_entry_points_raise_without_cuda_unless_told_cpu(monkeypatch, tmp_path):
    cfg = port_config(tiny_ranking_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="latency_benchmark: no CUDA device"):
        tbench.latency_benchmark(lambda: 1.0)
    with torch.device("meta"):
        model = RankingModel(cfg)
    with pytest.raises(RuntimeError, match="RankingEvaluator: no CUDA device"):
        teval.RankingEvaluator(cfg, model, {})
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine

    with pytest.raises(RuntimeError, match="from_checkpoint: no CUDA device"):
        RankingInferenceEngine.from_checkpoint(str(tmp_path))
    x = torch.ones(4)
    r = tbench.latency_benchmark(lambda: {"p": x * 2}, n_iters=5, warmup=1, batch_size=4,
                                 device="cpu")
    assert r["latency_ms_p50"] > 0 and r["throughput_per_s"] > 0
    assert "memory_in_use_mb" not in r  # no allocator statistics on the CPU
    params = init_params(cfg, seed=0, device="cpu")
    ev = teval.RankingEvaluator(cfg, model, params, device="cpu")
    assert all(v.device.type == "cpu" for v in ev.params.values())
