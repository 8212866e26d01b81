"""The port's statistical replicas held against the JAX package's, on the
CPU: the same seed gives the same arrays bit for bit (values and dtypes),
at the sizes of ``tests/test_replica.py``: the ML-1M replica and its
leave-one-out batches, and the OneTrans replica v1, v2 and with a
validation split, with their debug terms."""

import dataclasses

import numpy as np
import pytest
import torch

from recommend_tpu.config import get_config
from recommend_tpu.data import replica as jreplica
from recommend_tpu.data.datasets import leave_one_out_split as j_split
from recommend_tpu_torch import config as tconfig
from recommend_tpu_torch.data import replica as treplica
from recommend_tpu_torch.data.datasets import leave_one_out_split as t_split
from recommend_tpu_torch.data.synthetic import SyntheticRankingData, SyntheticRetrievalData
from tests.test_replica import small_ranking_cfg

torch.set_num_threads(1)


def _equal(a, b, what):
    """Arrays, dicts, lists and tuples of them equal, dtypes too."""
    if isinstance(b, dict):
        assert list(a) == list(b), what
        for k in b:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _same_data(t, j):
    assert type(t).__name__ == type(j).__name__
    assert type(t) in (SyntheticRankingData, SyntheticRetrievalData)
    for f in dataclasses.fields(j):
        _equal(getattr(t, f.name), getattr(j, f.name), f.name)


def _port(cfg):
    """The port's copy of a JAX config."""
    cls = tconfig.RankingConfig if hasattr(cfg, "tasks") else tconfig.RetrievalConfig
    return cls.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def ml1m():
    cfg = get_config("retrieval_small", video_vocab_size=4000)
    return cfg, (jreplica.make_ml1m_replica(cfg, num_users=400, num_items=3706, seed=0),
                 treplica.make_ml1m_replica(_port(cfg), num_users=400, num_items=3706, seed=0))


def test_ml1m_replica_is_bit_equal(ml1m):
    _, (j, t) = ml1m
    _same_data(t, j)
    lens = np.array([len(s["video_id"]) for s in t.user_sequences])
    assert lens.min() >= 20 and 120 < lens.mean() < 210  # the replica's marginals


@pytest.mark.parametrize("kw", [dict(), dict(num_items=50, seed=3, stay_prob=0.8,
                                              explore_prob=0.2, prefs_per_user=2)],
                         ids=["defaults", "options"])
def test_ml1m_replica_options_are_bit_equal(kw):
    cfg = get_config("retrieval_small", video_vocab_size=4000)
    _same_data(treplica.make_ml1m_replica(_port(cfg), num_users=30, **kw),
               jreplica.make_ml1m_replica(cfg, num_users=30, **kw))


@pytest.mark.parametrize("batch_size", [32, 37])
def test_leave_one_out_split_and_batches_are_equal(ml1m, batch_size):
    cfg, (j, t) = ml1m
    (jtr, jte), (ttr, tte) = j_split(j), t_split(t)
    _same_data(ttr, jtr)
    _same_data(tte, jte)
    jb = list(jreplica.leave_one_out_batches(jte, cfg, batch_size))
    tb = list(treplica.leave_one_out_batches(tte, _port(cfg), batch_size))
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        _equal(a, b, "batch")
    assert sum(b["num_real"] for b in tb) == len(tte.user_sequences)


ONETRANS_CASES = {
    # (config, make_onetrans_replica kwargs): tests/test_replica.py's sizes
    "v1": (small_ranking_cfg, dict(num_users=400, num_items=4000, num_impressions=16000,
                                   seed=0)),
    "v1_seed3": (small_ranking_cfg, dict(num_users=50, num_items=500, num_impressions=1000,
                                         seed=3)),
    "v2_val": (lambda: get_config("ranking_small", feature_vocab_sizes=(
        ("user_id", 300), ("age_bucket", 16), ("gender", 4), ("city", 32),
        ("item_id", 500), ("category", 200), ("brand", 500),
        ("price_bucket", 16), ("hour", 24), ("weekday", 7), ("device", 8))),
        dict(num_users=120, num_items=300, num_impressions=30_000, seed=3,
             signal_weights=(3.5, 2.0, -0.8, 0.5, -3.3), signal_weights_v2=(2.0, 2.5),
             val_frac=0.1)),
}


@pytest.mark.parametrize("case", sorted(ONETRANS_CASES))
def test_onetrans_replica_is_bit_equal_with_its_debug_terms(case):
    make_cfg, kw = ONETRANS_CASES[case]
    cfg = make_cfg()
    jdbg, tdbg = {}, {}
    j = jreplica.make_onetrans_replica(cfg, debug_out=jdbg, **kw)
    t = treplica.make_onetrans_replica(_port(cfg), debug_out=tdbg, **kw)
    assert len(t) == len(j) == (3 if kw.get("val_frac") else 2)
    for a, b in zip(t, j):
        _same_data(a, b)
    _equal(tdbg, jdbg, "debug_out")
    assert 0.1 < np.concatenate([d.labels["ctr"] for d in t]).mean() < 0.3
