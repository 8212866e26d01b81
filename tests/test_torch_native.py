"""The port's native (C++) batcher, held against its numpy path and the JAX
package's native path, on the CPU.

The library builds with g++ into the directory it is given (here
``tmp_path``), also from processes building at once; a failed build
raises with the compiler's output. ``fill_retrieval_batch`` equals the
numpy path and the JAX package's native batcher batch for batch;
``AliasSampler`` draws what the JAX package's sampler draws from the same
seed (the same C++ source), and its frequencies match the probabilities
(a chi-square test at p > 1e-4 and ``tests/test_native.py``'s 0.01 bound).
``retrieval_batches(use_native=True)`` equals ``use_native=False`` and the
JAX pipeline's batches.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from recommend_tpu.config import get_config
from recommend_tpu.data import native as jnative
from recommend_tpu.data.pipeline import retrieval_batches as j_retrieval_batches
from recommend_tpu.data.synthetic import make_retrieval_data as j_data
from recommend_tpu_torch.data import native
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from tests.test_torch_replica import _equal, _port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return native.load_native(tmp_path_factory.mktemp("native"))


@pytest.fixture(scope="module")
def jlib(tmp_path_factory):
    """The JAX package's ``native/batcher.cc``, built here under a temporary
    directory (its own loader writes into ``native/``, where the JAX tests
    build it), for the JAX package's ctypes wrappers."""
    import ctypes

    so = tmp_path_factory.mktemp("jax_native") / "librecbatch.so"
    src = Path(__file__).resolve().parents[1] / "native" / "batcher.cc"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _cfg():
    return get_config("retrieval_small", max_seq_len=32, compression_schedule=((16, 8), (16, 1)))


def test_the_batcher_builds_into_the_given_directory(tmp_path):
    lib = native.load_native(tmp_path)
    path = native.library_path(tmp_path)
    assert path.parent == tmp_path and path.exists()
    assert path.name.startswith("librecbatch-") and not list(tmp_path.glob("*.tmp"))
    assert native.load_native(tmp_path) is lib  # loaded once
    assert native.library_path() == native.BUILD_DIR / path.name  # build/native by default


def test_processes_building_at_once_do_not_race(tmp_path):
    code = ("import sys; from recommend_tpu_torch.data import native; "
            "native.load_native(sys.argv[1]).sample_alias")
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=root,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path(tmp_path).name]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.cc"
    bad.write_text("extern \"C\" void fill_retrieval_batch( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"native batcher build failed: batcher.cc "
                                           r"\(g\+\+ exit \d+\):\n.*error"):
        native.load_native(tmp_path / "out")
    assert not (tmp_path / "out").exists() or not list((tmp_path / "out").iterdir())


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(RuntimeError, match="native batcher build failed: g\\+\\+ not found"):
        native.load_native(tmp_path / "out")


def test_fill_retrieval_batch_equals_numpy_and_the_jax_batcher(lib, jlib):
    cfg = _cfg()
    data = make_retrieval_data(_port(cfg), num_users=30, num_videos=200, seed=0)
    probs = data.sampling_probs()
    flat, jflat = native.FlatSequences(data.user_sequences), jnative.FlatSequences(
        data.user_sequences)
    rng = np.random.default_rng(0)
    users = rng.integers(0, 30, 40)
    lens = np.array([len(s["video_id"]) for s in data.user_sequences])
    splits = (rng.random(40) * lens[users]).astype(np.int64)  # 0 <= split < len
    splits[:3] = (0, 1, cfg.max_seq_len + 5) % lens[users[:3]]  # empty, short, cut histories
    got = native.fill_retrieval_batch(lib, flat, users, splits, cfg.max_seq_len, probs)
    _equal(got, jnative.fill_retrieval_batch(jlib, jflat, users, splits, cfg.max_seq_len, probs),
           "jax native")
    from recommend_tpu_torch.data.pipeline import FEATURE_KEYS, _pad_history

    for b, (u, t) in enumerate(zip(users, splits)):
        seq = data.user_sequences[u]
        h, v = _pad_history(seq, t, cfg.max_seq_len)
        np.testing.assert_array_equal(got["history_valid"][b], v)
        for k in FEATURE_KEYS:
            np.testing.assert_array_equal(got["history"][k][b], h[k])
            assert got["target"][k][b] == seq[k][t]
        assert got["target_popularity"][b] == probs[seq["video_id"][t]]
    with pytest.raises(ValueError, match="outside its sequences"):
        native.fill_retrieval_batch(lib, flat, np.array([30]), np.array([0]), 8, probs)
    with pytest.raises(ValueError, match="outside its sequences"):
        native.fill_retrieval_batch(lib, flat, np.array([0]), lens[:1], 8, probs)


@pytest.mark.parametrize("shard", [(None, None), (2, 1)], ids=["whole", "shard"])
def test_native_retrieval_batches_equal_numpy_and_the_jax_pipeline(shard):
    cfg = _cfg()
    data = make_retrieval_data(_port(cfg), num_users=30, num_videos=200, seed=0)
    kw = dict(seed=5, num_epochs=2, num_shards=shard[0], shard_id=shard[1])
    got = list(retrieval_batches(data, _port(cfg), 16, use_native=True, **kw))
    assert len(got) > 2
    _equal(got, list(retrieval_batches(data, _port(cfg), 16, use_native=False, **kw)), "numpy")
    jd = j_data(cfg, num_users=30, num_videos=200, seed=0)
    _equal(got, list(j_retrieval_batches(jd, cfg, 16, use_native=False, **kw)), "jax")


def test_alias_sampler_draws_what_the_jax_sampler_draws(lib, jlib):
    probs = np.random.default_rng(0).random(50) ** 3
    for seed in (0, 1, 42):
        t, j = native.AliasSampler(lib, probs, seed=seed), jnative.AliasSampler(jlib, probs, seed)
        np.testing.assert_array_equal(t.prob, j.prob)
        np.testing.assert_array_equal(t.alias, j.alias)
        for _ in range(3):  # the seed advances per call alike
            np.testing.assert_array_equal(t.sample(1000), j.sample(1000))
            np.testing.assert_array_equal(t.sample_distinct_excluding(20, [1, 3, 5]),
                                          j.sample_distinct_excluding(20, [1, 3, 5]))
    t, j = native.AliasSampler(lib, np.ones(10), 2), jnative.AliasSampler(jlib, np.ones(10), 2)
    tight = t.sample_distinct_excluding(7, [0, 1, 2])  # the deterministic fallback
    np.testing.assert_array_equal(tight, j.sample_distinct_excluding(7, [0, 1, 2]))
    assert sorted(tight.tolist()) == [3, 4, 5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="8 distinct ids asked for, 7 not excluded"):
        t.sample_distinct_excluding(8, [0, 1, 2])


def test_alias_sampler_frequencies_match_the_probabilities(lib):
    from scipy.stats import chisquare

    probs = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625])
    draws = native.AliasSampler(lib, probs * 3.0, seed=42).sample(200_000)  # unnormalized
    counts = np.bincount(draws, minlength=len(probs))
    assert chisquare(counts, probs * len(draws)).pvalue > 1e-4
    np.testing.assert_allclose(counts / len(draws), probs, atol=0.01)
    out = native.AliasSampler(lib, np.ones(100), seed=1).sample_distinct_excluding(
        10, exclude=[0, 1, 2, 3, 4])
    assert len(set(out.tolist())) == 10 and not set(out.tolist()) & {0, 1, 2, 3, 4}
