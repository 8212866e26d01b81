"""The port's checkpoints, config files and the engine's load paths, held
against the JAX package on the CPU.

- ``CheckpointManager``: keep-N, ``latest_step``, ``restore`` of nothing;
- a resumed ``RankingTrainer`` equals an unbroken run bit for bit, dropout
  on (the generator's state travels in the checkpoint), a resume draws no
  fresh state, and a checkpoint of another layout raises the JAX trainer's
  error;
- a ``config.json`` that the JAX trainer's checkpoint manager wrote loads
  through the port's ``load_config`` field for field;
- an engine started from a port checkpoint scores as the JAX engine on the
  same weights (float32, 1e-5), and ``reload`` swaps weights in place and
  refreshes the live sessions;
- the trainer's ``profile_dir`` traces its window of steps, and the sparse
  update sums duplicate lookups per segment as ``index_add_`` does.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from recommend_tpu import config as jconfig
from recommend_tpu.serving.ranking_service import RankingInferenceEngine as JaxEngine
from recommend_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from recommend_tpu_torch.config import load_config, save_config
from recommend_tpu_torch.convert import init_params, params_from_flax
from recommend_tpu_torch.data import pipeline, synthetic
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_torch_ranking import jax_params, make_batch, port_config

torch.set_num_threads(1)

MAX_SEQ_LEN = 8


def _train_cfg(mode="rowwise", **kw):
    """_tiny_cfg with dropout on and a sparse or dense table update."""
    return port_config(dataclasses.replace(
        _tiny_cfg(), dropout_rate=0.1, use_sparse_embedding_updates=mode != "dense",
        sparse_update_mode="exact" if mode == "dense" else mode, batch_size=4, **kw))


def _batches(cfg, n):
    data = synthetic.make_ranking_data(cfg, num_samples=4 * n, max_seq_per_feature=8, seed=0)
    return list(pipeline.ranking_batches(data, cfg, 4, seed=0, num_epochs=1))[:n]


def _assert_trees_equal(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_manager_keeps_the_newest_and_restores_nothing_from_an_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    assert os.listdir(mgr.directory) == []
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((3,), float(step))}, ({"count": step}, {}),
                 config_dict={"step": step}, history={"train": [step]},
                 rng_state=torch.Generator().manual_seed(step).get_state())
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(mgr.directory)) == [
        "ckpt_00000002.pt", "ckpt_00000003.pt", "config.json", "history.json"]
    got = mgr.restore(map_location="cpu")
    assert got.step == 3 and torch.equal(got.params["w"], torch.full((3,), 3.0))
    assert got.opt_state == ({"count": 3}, {})
    assert torch.equal(got.rng_state, torch.Generator().manual_seed(3).get_state())
    assert json.load(open(os.path.join(mgr.directory, "config.json"))) == {"step": 3}
    mgr.wait()
    mgr.close()


@pytest.mark.parametrize("mode", ["rowwise", "dense"])
def test_resume_equals_an_unbroken_run_bit_for_bit(tmp_path, mode):
    """Two steps, a save, a new trainer that restores and takes a third,
    against three steps without a break: the same loss, parameters and
    optimizer state (count, moments, accumulators), bit for bit, with
    dropout at 0.1. Without the generator's state the third step draws
    other masks, so the check can tell."""
    cfg = _train_cfg(mode)
    batches = _batches(cfg, 3)
    ck = str(tmp_path / "ck")
    RankingTrainer(cfg, device="cpu", checkpoint_dir=ck).train(iter(batches[:2]), 2,
                                                               log_every=1)
    assert CheckpointManager(ck).latest_step() == 2
    resumed = RankingTrainer(cfg, device="cpu", checkpoint_dir=ck)
    got = resumed.train(iter(batches[2:]), 3, log_every=1)
    unbroken = RankingTrainer(cfg, device="cpu")
    want = unbroken.train(iter(batches), 3, log_every=1)
    assert got.step == want.step == 3
    assert resumed.history["train"][-1]["loss"] == unbroken.history["train"][-1]["loss"]
    _assert_trees_equal(got.params, want.params, "params")
    _assert_trees_equal(got.opt_state, want.opt_state, "opt_state")
    assert CheckpointManager(ck).steps() == [2, 3]

    # the same step-2 checkpoint without the generator's state
    step2 = torch.load(CheckpointManager(ck).path(2), weights_only=True)
    lost = str(tmp_path / "lost")
    CheckpointManager(lost).save(2, step2["params"], step2["opt_state"])
    blind = RankingTrainer(cfg, device="cpu", checkpoint_dir=lost).train(
        iter(batches[2:]), 3, log_every=1)
    assert not all(torch.equal(blind.params[k], want.params[k]) for k in want.params)


def test_a_resume_draws_no_fresh_state(tmp_path, monkeypatch):
    """With a checkpoint at hand, ``init_state`` compares layouts on the
    meta device and returns the restored tensors: ``init_params`` is never
    called, and only the dense parameters take gradients."""
    from recommend_tpu_torch.training import ranking_trainer

    cfg = _train_cfg("rowwise")
    ck = str(tmp_path / "ck")
    RankingTrainer(cfg, device="cpu", checkpoint_dir=ck).train(iter(_batches(cfg, 1)), 1)

    def no_draw(*args, **kwargs):
        raise AssertionError("a resume drew a fresh state")

    monkeypatch.setattr(ranking_trainer, "init_params", no_draw)
    trainer = RankingTrainer(cfg, device="cpu", checkpoint_dir=ck)
    state = trainer.init_state(seed=0)
    saved = torch.load(CheckpointManager(ck).path(1), weights_only=True)
    assert state.step == 1
    _assert_trees_equal(state.params, saved["params"], "params")
    assert all(t.device.type == "cpu" for t in state.params.values())
    assert {k for k, t in state.params.items() if not t.requires_grad} == set(trainer.tables)


def test_checkpoint_of_another_layout_raises_the_jax_error(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = _train_cfg("rowwise")
    RankingTrainer(cfg, device="cpu", checkpoint_dir=ck).train(iter(_batches(cfg, 1)), 1)
    exact = RankingTrainer(_train_cfg("exact"), device="cpu", checkpoint_dir=ck)
    with pytest.raises(RuntimeError, match="incompatible with this config"):
        exact.init_state(seed=0)
    wide = RankingTrainer(dataclasses.replace(cfg, feature_vocab_sizes=tuple(
        (f, v + 1) for f, v in cfg.feature_vocab_sizes)), device="cpu", checkpoint_dir=ck)
    with pytest.raises(RuntimeError, match="incompatible with this config"):
        wide.init_state(seed=0)


def test_jax_trainers_config_json_loads_field_for_field(tmp_path):
    """The JAX trainer writes config.json through its checkpoint manager
    (``cfg.to_dict()``, ranking_trainer.py:466-484); the port reads it as
    plain JSON, and writes the same file."""
    cfg = jconfig.get_config("ranking_small", num_heads=2, use_flash_attention=True,
                             task_logit_bias_init=(-1.0, -2.0),
                             semantic_features=(("title", 8),))
    mgr = JaxCheckpointManager(str(tmp_path / "jax"))
    mgr.save(0, {"w": np.zeros(2, np.float32)}, {"count": np.zeros((), np.int32)},
             config_dict=cfg.to_dict(), history={"train": []})
    mgr.wait()
    mgr.close()
    got = load_config(str(tmp_path / "jax" / "config.json"))
    assert [(f.name, getattr(got, f.name)) for f in dataclasses.fields(got)] == [
        (f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)]
    save_config(got, str(tmp_path / "port.json"))
    assert json.load(open(tmp_path / "port.json")) == json.load(
        open(tmp_path / "jax" / "config.json"))
    # a retrieval config file loads too, field for field
    rcfg = jconfig.get_config("retrieval_small")
    jconfig.save_config(rcfg, str(tmp_path / "r.json"))
    got = load_config(str(tmp_path / "r.json"))
    assert type(got).__name__ == "RetrievalConfig"
    assert [(f.name, getattr(got, f.name)) for f in dataclasses.fields(got)] == [
        (f.name, getattr(rcfg, f.name)) for f in dataclasses.fields(rcfg)]


def _request(seed=0):
    rng = np.random.default_rng(seed)
    user = {"user_id": int(rng.integers(0, 1000)), "age_bucket": 2, "gender": 1,
            "city": 3, "hour": 12, "weekday": 3, "device": 1}
    seqs = {"click_seq": rng.integers(1, 2000, size=11).tolist(), "cart_seq": [5, 6],
            "purchase_seq": []}
    cands = [{"item_id": int(rng.integers(0, 2000)), "category": int(rng.integers(0, 50)),
              "brand": int(rng.integers(0, 100)), "price_bucket": 3} for _ in range(5)]
    return user, seqs, cands


def _max_diff(a, b, tasks):
    return max(abs(x[t] - y[t]) for x, y in zip(a, b) for t in tasks)


def test_engine_from_a_port_checkpoint_scores_like_the_jax_engine(tmp_path):
    """The port trainer saves the JAX model's weights (converted by
    ``params_from_flax``); ``from_checkpoint`` reads config.json and the
    checkpoint, and scores every request path as the JAX engine on the flax
    tree (float32, 1e-5)."""
    cfg = _tiny_cfg()
    jp = jax_params(cfg, make_batch(cfg, seq_len=MAX_SEQ_LEN))
    tcfg = port_config(cfg)
    ck = str(tmp_path / "ck")
    trainer = RankingTrainer(tcfg, device="cpu", checkpoint_dir=ck)
    state = trainer.init_state(params_from_flax(jax.tree_util.tree_map(np.asarray, jp), tcfg))
    trainer._save(state, torch.Generator())
    port = RankingInferenceEngine.from_checkpoint(ck, max_seq_len=MAX_SEQ_LEN, device="cpu")
    assert port.cfg == tcfg
    ref = JaxEngine(cfg, jp, max_seq_len=MAX_SEQ_LEN)
    for seed in range(3):
        user, seqs, cands = _request(seed)
        assert _max_diff(port.score_request(user, seqs, cands),
                         ref.score_request(user, seqs, cands), cfg.tasks) <= 1e-5
        rows = [(dict(user, **c), seqs) for c in cands]
        assert _max_diff(port.batch_inference(rows), ref.batch_inference(rows),
                         cfg.tasks) <= 1e-5
    with pytest.raises(FileNotFoundError):
        RankingInferenceEngine.from_checkpoint(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("source", ["params", "checkpoint_dir"])
def test_reload_writes_in_place_and_refreshes_sessions(tmp_path, source):
    """``reload`` from a state dict or a checkpoint: the engine's tensors
    keep their storage, a live session scores as a fresh engine on the new
    weights does (float32, exact path: 1e-6), and a state dict of another
    shape raises before anything is written."""
    cfg = port_config(_tiny_cfg())
    old, new = (init_params(cfg, seed=s, device="cpu") for s in (0, 1))
    engine = RankingInferenceEngine(cfg, old, max_seq_len=MAX_SEQ_LEN, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in engine.state_dict().items()}
    user, seqs, cands = _request()
    engine.update_session("s", seqs)
    before = engine.score_session("s", user, cands)
    if source == "params":
        engine.reload(params=new)
    else:
        ck = str(tmp_path / "ck")
        CheckpointManager(ck).save(7, new, {})
        engine.reload(checkpoint_dir=ck)
    assert {k: t.data_ptr() for k, t in engine.state_dict().items()} == ptrs
    _assert_trees_equal(engine.state_dict(), new)
    fresh = RankingInferenceEngine(cfg, new, max_seq_len=MAX_SEQ_LEN, device="cpu")
    fresh.update_session("s", seqs)
    got = engine.score_session("s", user, cands)
    assert _max_diff(got, fresh.score_session("s", user, cands), cfg.tasks) <= 1e-6
    assert _max_diff(got, before, cfg.tasks) > 1e-3

    bad = dict(new)
    name = "tokenizer.embeds.user_id.weight"
    bad[name] = torch.zeros(bad[name].shape[0] + 1, bad[name].shape[1])
    with pytest.raises(ValueError, match=name):
        engine.reload(params=bad)
    missing = {k: v for k, v in new.items() if k != name}
    with pytest.raises(ValueError, match="names differ"):
        engine.reload(params=missing)
    with pytest.raises(ValueError, match="exactly one"):
        engine.reload()
    _assert_trees_equal(engine.state_dict(), new)


def test_profile_dir_traces_the_step_window(tmp_path):
    """``train(profile_dir=...)`` writes one Chrome trace of steps
    [start + profile_start, + profile_num_steps), with each step's range."""
    cfg = _train_cfg()
    prof = tmp_path / "prof"
    RankingTrainer(cfg, device="cpu").train(iter(_batches(cfg, 4)), 4, log_every=10,
                                            profile_dir=str(prof), profile_start=1,
                                            profile_num_steps=2)
    assert [p.name for p in prof.iterdir()] == ["trace_1-3.json"]
    names = {e.get("name") for e in json.load(open(prof / "trace_1-3.json"))["traceEvents"]}
    assert {"train_step_1", "train_step_2"} <= names and "train_step_0" not in names


def test_the_sparse_update_sums_duplicates_per_segment_as_index_add_does():
    """The sparse update sums a row's lookups per segment of the sorted ids
    (one thread per segment on CUDA, in lookup order: no atomics, so a
    resumed run on the card repeats an unbroken one). The segment sums equal
    ``index_add_``'s, which adds in lookup order on the CPU, bit for bit, and
    the row-wise update equals the per-lookup scatter-add formulation (the
    JAX package's) to float32 rounding."""
    from recommend_tpu_torch.ops import sparse_embed

    gen = torch.Generator().manual_seed(0)
    v, d, n = 9, 3, 60
    ids = torch.randint(-1, v + 1, (n,), generator=gen)  # -1 and v are dropped
    g = torch.randn(n, d, generator=gen)
    uids, sums = sparse_embed.dedup_sum(ids, g, v)
    live = ids[(ids >= 0) & (ids < v)].unique()
    assert torch.equal(uids[:len(live)], live) and bool((uids[len(live):] == v).all())
    for u in live.tolist():
        slot = int((uids == u).nonzero()[0])
        rows = g[ids == u]
        want = torch.zeros(1, d).index_add_(0, torch.zeros(len(rows), dtype=torch.long), rows)[0]
        assert torch.equal(sums[slot], want), u
    table, accum = torch.randn(v, d, generator=gen), torch.full((v,), 0.1)
    ref_t, ref_a = table.clone(), accum.clone()
    sparse_embed.sparse_rowwise_update_table(table, accum, ids, g, 0.3)
    keep, safe = sparse_embed._dropped(ids, v)  # the per-lookup formulation
    ref_a.index_add_(0, safe, torch.where(keep, g.square().mean(-1), 0.0))
    acc = ref_a[safe]
    scale = torch.where(keep & (acc > 0), torch.rsqrt(acc + 1e-7), 0.0)
    ref_t.index_add_(0, safe, -(0.3 * g * scale[:, None]))
    torch.testing.assert_close(accum, ref_a, rtol=0, atol=1e-6)
    torch.testing.assert_close(table, ref_t, rtol=0, atol=1e-6)
