"""The port's open-dataset loaders held against the JAX package's, on the
CPU, on ``tests/test_datasets.py``'s fixtures (written under ``tmp_path``;
no dataset file is in the repository and none is fetched).

``load_movielens_1m``, ``leave_one_out_split``, ``load_taobao_userbehavior``
and ``load_criteo_kaggle`` give the JAX loaders' arrays (values and dtypes)
and ``criteo_ranking_config`` its config field for field; the MovieLens
data feeds ``retrieval_batches`` (native and numpy) as the JAX pipeline
batches it; and an NS-only ranking step from the Criteo config (dense and
rowwise-sparse) matches the JAX trainer's at float32: loss rtol 1e-5, grad
norm rtol 1e-4, parameters and tables atol 1e-5 / rtol 1e-4. The step runs
rmsprop (tame settings, as ``tests/test_ranking_model.py``'s tiny config),
not the JAX test's adam: adam's update g / (|g| + 1e-8) turns the rounding
noise of a gradient element near 0 into a step of up to lr, so two correct
implementations part by ~lr on a few such elements (2 of 319,488 after two
steps here).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recommend_tpu.config import get_config
from recommend_tpu.data import datasets as jdatasets
from recommend_tpu.data.pipeline import ranking_batches as j_ranking_batches
from recommend_tpu.data.pipeline import retrieval_batches as j_retrieval_batches
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch import config as tconfig
from recommend_tpu_torch.convert import accums_from_flax, params_from_flax
from recommend_tpu_torch.data import datasets as tdatasets
from recommend_tpu_torch.data.pipeline import retrieval_batches as t_retrieval_batches
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_datasets import ml1m_dir, taobao_csv  # noqa: F401 (fixtures)
from tests.test_torch_replica import _equal, _port, _same_data

torch.set_num_threads(1)


def test_movielens_loader_matches_jax(ml1m_dir):  # noqa: F811
    for kw in (dict(min_interactions=4), dict(min_interactions=2, max_users=2),
               dict(min_interactions=4, movies_file="absent.dat")):
        cfg = get_config("retrieval_small")
        j = jdatasets.load_movielens_1m(ml1m_dir, cfg, **kw)
        t = tdatasets.load_movielens_1m(ml1m_dir, _port(cfg), **kw)
        _same_data(t, j)
        assert len(t.user_sequences) > 0


def test_movielens_missing_file_and_small_vocab_raise(tmp_path, ml1m_dir):  # noqa: F811
    cfg = _port(get_config("retrieval_small"))
    with pytest.raises(FileNotFoundError):
        tdatasets.load_movielens_1m(str(tmp_path / "nowhere"), cfg)
    with pytest.raises(ValueError, match="exceed cfg.video_vocab_size"):
        tdatasets.load_movielens_1m(ml1m_dir, dataclasses.replace(cfg, video_vocab_size=3))


def test_leave_one_out_split_matches_jax(ml1m_dir):  # noqa: F811
    cfg = get_config("retrieval_small")
    j = jdatasets.load_movielens_1m(ml1m_dir, cfg, min_interactions=2)
    t = tdatasets.load_movielens_1m(ml1m_dir, _port(cfg), min_interactions=2)
    for min_train in (2, 4):
        for a, b in zip(tdatasets.leave_one_out_split(t, min_train),
                        jdatasets.leave_one_out_split(j, min_train)):
            _same_data(a, b)


def test_movielens_batches_match_the_jax_pipeline(ml1m_dir):  # noqa: F811
    cfg = get_config("retrieval_small", max_seq_len=8, compression_schedule=((4, 2), (4, 1)),
                     video_vocab_size=16, category_vocab_size=32, tag_vocab_size=64)
    data = tdatasets.load_movielens_1m(ml1m_dir, _port(cfg), min_interactions=4)
    want = list(j_retrieval_batches(jdatasets.load_movielens_1m(ml1m_dir, cfg,
                                                                min_interactions=4),
                                    cfg, batch_size=2, min_history=1, num_epochs=2,
                                    use_native=False))
    for native in (True, False):
        got = list(t_retrieval_batches(data, _port(cfg), batch_size=2, min_history=1,
                                       num_epochs=2, use_native=native))
        _equal(got, want, f"native={native}")


@pytest.mark.parametrize("kw", [dict(max_seq_per_feature=4, negatives_per_positive=1, seed=0),
                                dict(max_seq_per_feature=2, negatives_per_positive=3, seed=5,
                                     max_samples_per_user=1),
                                dict(max_seq_per_feature=4, max_users=1)],
                         ids=["defaults", "options", "one_user"])
def test_taobao_loader_matches_jax(taobao_csv, kw):  # noqa: F811
    cfg = get_config("ranking_small")
    _same_data(tdatasets.load_taobao_userbehavior(taobao_csv, _port(cfg), **kw),
               jdatasets.load_taobao_userbehavior(taobao_csv, cfg, **kw))


def test_taobao_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdatasets.load_taobao_userbehavior(str(tmp_path / "UserBehavior.csv"),
                                           _port(get_config("ranking_small")))


def criteo_file(tmp_path, n=96):
    """``tests/test_datasets.py``'s Criteo sample: empty fields, negative
    integers, hashed categories."""
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(n):
        label = int(rng.random() < 0.3)
        ints = ["" if rng.random() < 0.2 else str(int(rng.integers(-2, 5000)))
                for _ in range(13)]
        cats = ["" if rng.random() < 0.2 else f"{int(rng.integers(0, 2**32)):08x}"
                for _ in range(26)]
        rows.append("\t".join([str(label)] + ints + cats))
    rows.append("malformed\tline")
    p = tmp_path / "criteo_sample.txt"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


CRITEO_CFG = dict(cat_vocab=512, num_buckets=16, embed_dim=64, num_layers=2, num_heads=1,
                  ffn_dim=128, num_ns_tokens=4, pyramid_ratios=(1.0, 1.0), batch_size=32,
                  use_mixed_precision=False, dropout_rate=0.0, dense_optimizer="adam",
                  dense_lr=1e-3)


def test_criteo_config_and_loader_match_jax(tmp_path):
    for kw in (dict(), CRITEO_CFG):
        j = jdatasets.criteo_ranking_config(**kw)
        t = tdatasets.criteo_ranking_config(**kw)
        assert type(t) is tconfig.RankingConfig
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    path = criteo_file(tmp_path)
    for kw in (dict(cat_vocab=512, num_buckets=16), dict(max_samples=40)):
        t = tdatasets.load_criteo_kaggle(path, **kw)
        _same_data(t, jdatasets.load_criteo_kaggle(path, **kw))
    assert tdatasets.load_criteo_kaggle(path).num_samples == 96
    with pytest.raises(FileNotFoundError):
        tdatasets.load_criteo_kaggle(str(tmp_path / "absent.txt"))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "rowwise"])
def test_ns_only_step_from_the_criteo_config_matches_the_jax_trainer(tmp_path, sparse):
    """Criteo has no behavior sequences: the tokenizer's S length is 0 and
    only the NS tokens go through the layers. Two steps from the JAX
    trainer's converted state on the loader's batches."""
    kw = dict(CRITEO_CFG, dense_optimizer="rmsprop", dense_momentum=0.9,
              use_sparse_embedding_updates=sparse, sparse_update_mode="rowwise", sparse_lr=0.05)
    cfg = jdatasets.criteo_ranking_config(**kw)
    tcfg = tdatasets.criteo_ranking_config(**kw)
    data = jdatasets.load_criteo_kaggle(criteo_file(tmp_path), cat_vocab=512, num_buckets=16)
    batches = list(j_ranking_batches(data, cfg, batch_size=32, seed=0, num_epochs=1))[:2]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jt = JaxTrainer(cfg)
    js = jt.init_state(jax.random.key(0), batches[0])
    tt = RankingTrainer(tcfg, device="cpu")
    ts = tt.init_state(params_from_flax(np_tree(js.params), tcfg),
                       accums=accums_from_flax(np_tree(js.opt_state[1]), tcfg) if sparse
                       else None)
    for batch in batches:
        js, jm = jt._train_step(js, jt._put_batch(batch), jax.random.key(0))
        ts, tm = tt._train_step(ts, tt._put_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for k, v in params_from_flax(np_tree(js.params), tcfg).items():
        if not torch.isnan(v).any():  # absent from the flax tree
            np.testing.assert_allclose(ts.params[k].detach().numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)
