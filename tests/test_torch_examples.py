"""The port's entry points (``examples_torch/``) on the CPU, each as its
``main`` runs it (``run(parse_args(argv))``) at small flags with ``--device
cpu``:

- ``train_ranking`` writes the JAX script's files (``<model_dir>/ckpt``
  with ``config.json``, ``logs/``, ``eval.json`` with the JAX evaluator's
  keys, ``push_<step>.npz``); ``evaluate ranking`` on the checkpoint it
  wrote gives, bit for bit, what ``RankingEvaluator`` gives in-process on
  the trainer's final params over the same batches; the push applied to an
  engine at the trainer's initial params holds the checkpoint's state bit
  for bit; each ``--eval_type`` writes its own key; ``--criteo`` and
  ``--taobao`` read local files;
- ``train_retrieval --quick-start`` writes ``config.json``, ``ckpt/`` and
  ``eval.json`` with the JAX script's keys, and ``evaluate retrieval`` on
  its checkpoint gives the in-process evaluator's metrics bit for bit;
  ``--movielens`` reads a local directory;
- ``serving_demo --tiny`` runs the sweep, the session loop and the
  recommender; ``online_learning_demo`` trains on from its checkpoint, and
  its refreshed int8 index answers as one built fresh from the final state
  over the corpus and the appended items.

The file names and the reports' top-level keys come from the JAX scripts'
code (``test_torch_examples_jax.py`` runs the JAX ``train_retrieval`` and
``serving_demo`` beside the port's); the reports themselves are the
evaluators', which ``test_torch_evaluation.py`` and
``test_torch_retrieval_serving.py`` hold to the JAX package's key for key
and value for value.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from examples_torch import (evaluate, online_learning_demo, serving_demo, train_ranking,
                            train_retrieval)
from recommend_tpu_torch.config import load_config
from recommend_tpu_torch.convert import init_params
from recommend_tpu_torch.data import datasets as tdatasets
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
from recommend_tpu_torch.serving.param_push import load_push, table_keys
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_datasets import criteo_file

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
RANKING = ["--steps", "6", "--batch_size", "8", "--num_samples", "200", "--eval_every", "3",
           "--tame-optimizer", *CPU]
CRITEO_WIDTHS = dict(embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, num_ns_tokens=4,
                     pyramid_ratios=(1.0, 1.0), feature_embed_dim=8, task_head_hidden=16)
RETRIEVAL_METRICS = ({f"{m}@{k}" for m in ("recall", "ndcg") for k in (1, 5, 10, 50, 100)}
                     | {"mrr", "map"})


def _run(script, argv):
    """What ``script``'s run returns, as its ``main(argv)`` runs it."""
    return script.run(script.parse_args(argv))


@pytest.fixture(scope="module")
def ranking_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranking")
    out = _run(train_ranking, [*RANKING, "--model_dir", str(d / "model"), "--push-dir",
                               str(d / "push")])
    return d, out


def _without_time(report):
    return {k: v for k, v in report.items() if k != "throughput_samples_per_s"}


def test_train_ranking_writes_the_jax_scripts_files(ranking_run):
    d, out = ranking_run
    model = d / "model"
    cfg, state = out["cfg"], out["state"]
    assert state.step == 6 and cfg.use_flash_attention is False
    assert load_config(str(model / "ckpt" / "config.json")) == cfg
    assert CheckpointManager(str(model / "ckpt")).latest_step() == 6
    assert (model / "logs" / "train.jsonl").exists() and (model / "logs" / "val.jsonl").exists()
    report = json.loads((model / "eval.json").read_text())
    assert set(report) == set(out["metrics"]) | {"timestamp"}
    assert {f"{t}_{m}" for t in cfg.tasks for m in ("auc", "uauc", "logloss")} <= set(report)
    assert report["num_samples"] == 64  # the JAX script's 8 batches
    assert [p.name for p in (d / "push").iterdir()] == ["push_00000006.npz"]
    assert len(out["scored"]) == 10 and set(out["scored"][0]) == set(cfg.tasks)


def test_evaluate_ranking_on_the_checkpoint_equals_the_in_process_evaluator(
        ranking_run, tmp_path):
    d, out = ranking_run
    ev = _run(evaluate, ["ranking", "--checkpoint", str(d / "model" / "ckpt"), "--output",
                         str(tmp_path), *CPU])
    cfg, state = out["cfg"], out["state"]
    data = evaluate.ranking_eval_data(cfg, 4)
    ref = RankingEvaluator(cfg, out["trainer"].model, state.params, device="cpu").evaluate(
        evaluate.ranking_eval_batches(data, cfg, 4, seed=7))
    np.testing.assert_equal(_without_time(ev["offline"]), _without_time(ref))  # NaN too
    assert {"control", "treatment", "relative_lift", "auc_lift_ci95"} <= set(ev["ab_test"])
    assert set(ev["feature_importance"]) == set(cfg.non_seq_features)
    # one request of min(100, the stream's 2 x 4 x 8 rows) candidates
    assert ev["benchmark"]["candidates"] == 64 and ev["benchmark"]["latency_ms_p50"] > 0
    saved = json.loads((tmp_path / "ranking_eval.json").read_text())
    assert set(saved) == {"timestamp", "offline", "ab_test", "feature_importance", "benchmark"}


def test_the_push_makes_an_engine_at_the_initial_params_the_checkpoint(ranking_run):
    d, out = ranking_run
    cfg = out["cfg"]
    engine = RankingInferenceEngine(cfg, init_params(cfg, seed=0, device="cpu"), device="cpu")
    before = {k: v.clone() for k, v in engine.state_dict().items()}
    engine.apply_push(load_push(out["push_path"], engine.state_dict(), table_keys(cfg)))
    ckpt = CheckpointManager(str(d / "model" / "ckpt")).restore()
    got = engine.state_dict()
    assert set(got) == set(ckpt.params)
    for k, v in ckpt.params.items():
        assert torch.equal(got[k], v), k
    # the push carried something: the trained state is not the initial one
    assert any(not torch.equal(before[k], v) for k, v in ckpt.params.items())


@pytest.mark.parametrize("eval_type,key", [("offline", "offline"), ("ab_test", "ab_test"),
                                           ("importance", "feature_importance"),
                                           ("benchmark", "benchmark")])
def test_each_eval_type_writes_its_report(ranking_run, eval_type, key):
    d, _ = ranking_run
    ev = _run(evaluate, ["ranking", "--checkpoint", str(d / "model" / "ckpt"), "--eval_type",
                         eval_type, "--batches", "1", *CPU])
    assert set(ev) == {key}


def test_evaluate_without_a_checkpoint_raises(tmp_path):
    from recommend_tpu_torch.config import get_config, save_config

    for cmd, preset in (("ranking", "ranking_small"), ("retrieval", "retrieval_small")):
        d = tmp_path / cmd
        d.mkdir()
        save_config(get_config(preset), str(d / "config.json"))
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            evaluate.main([cmd, "--checkpoint", str(d), *CPU])


def _taobao_csv(tmp_path, users=40, items=60):
    rng = np.random.default_rng(0)
    rows, ts = [], 1511660000
    for u in range(1, users + 1):
        for _ in range(12):
            item = int(rng.integers(1, items))
            ts += 60
            rows.append(f"{u},{item},{item % 7 + 1},pv,{ts}")
            if rng.random() < 0.3:
                ts += 60
                rows.append(f"{u},{item},{item % 7 + 1},{rng.choice(['cart', 'fav', 'buy'])},"
                            f"{ts}")
    p = tmp_path / "UserBehavior.csv"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


@pytest.mark.parametrize("source", ["criteo", "taobao"])
def test_train_ranking_reads_local_criteo_and_taobao_files(tmp_path, monkeypatch, source):
    if source == "criteo":
        # the config and the loader at 512 hashed ids a field and narrow
        # widths (the script's are ranking_base's, 26 x 65,536-row tables)
        cfg_fn, load_fn = tdatasets.criteo_ranking_config, tdatasets.load_criteo_kaggle
        monkeypatch.setattr(tdatasets, "criteo_ranking_config", lambda **kw: cfg_fn(
            cat_vocab=512, **{**CRITEO_WIDTHS, **kw}))
        monkeypatch.setattr(tdatasets, "load_criteo_kaggle",
                            lambda path, **kw: load_fn(path, cat_vocab=512, **kw))
    path = criteo_file(tmp_path) if source == "criteo" else _taobao_csv(tmp_path)
    out = _run(train_ranking, ["--steps", "2", "--batch_size", "8", "--eval_every", "2",
                               f"--{source}", path, "--model_dir", str(tmp_path / "m"), *CPU])
    assert out["data"].num_samples >= 16 and out["state"].step == 2
    assert np.isfinite(out["metrics"]["ctr_auc_streaming"])
    if source == "criteo":
        assert out["cfg"].sequence_features == () and out["cfg"].tasks == ("ctr",)


@pytest.fixture(scope="module")
def retrieval_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("retrieval")
    out = _run(train_retrieval, ["--quick-start", "--batch_size", "16", "--model_dir",
                                 str(d / "model"), *CPU])
    return d, out


def test_train_retrieval_quick_start_writes_the_jax_scripts_files(retrieval_run):
    d, out = retrieval_run
    model = d / "model"
    assert out["state"].step == 100  # --quick-start's steps
    assert load_config(str(model / "config.json")) == out["cfg"]
    assert CheckpointManager(str(model / "ckpt")).latest_step() == 100
    assert (model / "logs" / "train.jsonl").exists()
    assert set(json.loads((model / "eval.json").read_text())) == RETRIEVAL_METRICS | {
        "timestamp"}
    assert set(out["latency"]) >= {"batch_size", "latency_ms_p50", "throughput_qps"}


def test_evaluate_retrieval_on_the_checkpoint_equals_the_in_process_evaluator(
        retrieval_run, tmp_path):
    d, out = retrieval_run
    ev = _run(evaluate, ["retrieval", "--checkpoint", str(d / "model" / "ckpt"), "--output",
                         str(tmp_path), "--batches", "2", *CPU])
    assert set(ev) == {"retrieval", "classification", "latency"}
    cfg, data = evaluate._load_retrieval(str(d / "model" / "ckpt"), "cpu")[::3]
    ref = RetrievalEvaluator(cfg, out["state"].params, device="cpu")
    assert ev["retrieval"] == ref.evaluate_retrieval(
        data, itertools.islice(retrieval_batches(data, cfg, cfg.batch_size, seed=7), 2))
    assert ev["classification"] == ref.evaluate_classification(
        data, itertools.islice(retrieval_batches(data, cfg, cfg.batch_size, seed=8), 2))
    saved = json.loads((tmp_path / "retrieval_eval.json").read_text())
    assert set(saved) == {"timestamp", "retrieval", "classification", "latency"}


def test_train_retrieval_reads_a_local_movielens_directory(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "movies.dat").write_text(
        "".join(f"{m}::Movie {m} (1995)::Drama|Comedy\n" for m in range(1, 61)),
        encoding="latin-1")
    (tmp_path / "ratings.dat").write_text("".join(
        f"{u}::{int(m)}::4::{978300000 + u * 1000 + t}\n"
        for u in range(1, 41) for t, m in enumerate(rng.integers(1, 151, size=15))))
    out = _run(train_retrieval, ["--movielens", str(tmp_path), "--steps", "4",
                                 "--batch_size", "8", "--model_dir", str(tmp_path / "m"), *CPU])
    assert len(out["data"].user_sequences) == 40 and out["state"].step == 4
    assert set(out["metrics"]) == RETRIEVAL_METRICS


def test_serving_demo_tiny_runs_every_flow():
    out = _run(serving_demo, ["--tiny", "--requests", "10", "--candidates", "20", *CPU])
    assert sorted(out["sweep_ms"]) == [1, 10, 20, 50] and out["qps"] > 0
    stats = out["ranking_stats"]
    # the sweep's 4 x 6 requests, then 10 session requests; none failed
    assert stats["total"] == stats["success"] == 34 and stats["failure"] == 0
    assert len(out["recs"]) == 5 and all(np.isfinite(r["score"]) for r in out["recs"])
    assert out["retrieval_stats"]["requests"] == 1


def test_online_learning_demo_refreshes_the_index_with_the_new_items(tmp_path):
    out = _run(online_learning_demo, ["--steps", "10", "--videos", "500", "--model_dir",
                                      str(tmp_path / "m"), *CPU])
    assert out["first_step"] == 10 and out["state"].step == 20 and out["new_items_indexed"]
    assert CheckpointManager(str(tmp_path / "m")).latest_step() == 20
    corpus = out["data"].corpus_features()
    both = {k: np.concatenate([v, v[:8]]) for k, v in corpus.items()}
    both["video_id"][-8:] = np.arange(500, 508)
    fresh = RetrievalIndex(out["cfg"], out["state"].params, quantize="int8",
                           approx_recall=0.99, device="cpu")
    fresh.build(both)
    assert torch.equal(fresh.item_embeddings, out["index"].item_embeddings)
    interests = np.random.default_rng(0).normal(
        size=(1, out["cfg"].num_query_tokens, out["cfg"].embed_dim)).astype(np.float32)
    np.testing.assert_array_equal(fresh.search(interests)[1], out["ids_after"])
