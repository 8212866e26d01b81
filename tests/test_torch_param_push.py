"""The port's incremental parameter push held against the JAX package's
``serving/param_push.py`` on the CPU.

Both trainers take the same six rowwise sparse steps from the same converted
state on the same batches, each with its own tracker wrapped around them.
The trackers mark the same ids; each push rebuilds its trainer's parameters
bit for bit from the base; the two pushes agree (float32, atol 1e-5, rtol
1e-4: six optimizer steps apart in summation order). The engine serves the
pushed weights as the JAX engine serves its push, and a malformed push
raises and leaves the engine as it was.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.data.synthetic import make_ranking_data
from recommend_tpu.serving import param_push as jpush
from recommend_tpu.serving.ranking_service import RankingInferenceEngine as JaxEngine
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.convert import _flax_table_key, accums_from_flax, params_from_flax
from recommend_tpu_torch.serving.param_push import (
    PushTracker,
    apply_push,
    build_push,
    load_push,
    push_nbytes,
    save_push,
    table_keys,
)
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from tests.test_ranking_model import tiny_ranking_cfg
from tests.test_torch_ranking import port_config

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)


def _sparse_cfg(**kw):
    return tiny_ranking_cfg(use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
                            batch_size=4, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    """Base params, both trainers' params after 6 observed steps, both
    trackers, and the JAX base tree."""
    cfg = _sparse_cfg()
    tcfg = port_config(cfg)
    data = make_ranking_data(cfg, num_samples=24, max_seq_per_feature=8, seed=0)
    batches = list(itertools.islice(ranking_batches(data, cfg, batch_size=4, seed=0), 6))
    jt = JaxTrainer(cfg)
    js0 = jt.init_state(jax.random.key(0), batches[0])
    jbase = _np_tree(js0.params)
    jtracker = jpush.PushTracker(cfg)
    jstate = jt.train(jtracker.wrap(iter(batches)), num_steps=6, log_every=10)

    base = params_from_flax(jbase, tcfg)
    tt = RankingTrainer(tcfg, device="cpu")
    state = tt.init_state(base, accums=accums_from_flax(_np_tree(js0.opt_state[1]), tcfg))
    tracker = PushTracker(tcfg)
    for b in tracker.wrap(batches):
        state, _ = tt._train_step(state, tt._put_batch(b))
    return dict(cfg=cfg, tcfg=tcfg, base=base, final=state.params, tracker=tracker,
                jbase=jbase, jfinal=jstate.params, jtracker=jtracker, batches=batches)


def _snapshot_as_jax(snap):
    return {_flax_table_key(k): v for k, v in snap.items()}


def test_tracker_marks_exactly_the_jax_trackers_ids():
    cfg = _sparse_cfg()
    tcfg = port_config(cfg)
    data = make_ranking_data(cfg, num_samples=8, max_seq_per_feature=6, seed=1)
    batch = next(iter(ranking_batches(data, cfg, batch_size=4, seed=0)))
    tracker, jtracker = PushTracker(tcfg), jpush.PushTracker(cfg)
    tracker.observe(batch)
    jtracker.observe(batch)
    snap, jsnap = tracker.snapshot(), jtracker.snapshot()
    assert set(snap) == set(table_keys(tcfg))
    assert set(_snapshot_as_jax(snap)) == set(jsnap)
    for k, v in _snapshot_as_jax(snap).items():
        np.testing.assert_array_equal(v, jsnap[k], err_msg=k)
    for f in cfg.non_seq_features:
        np.testing.assert_array_equal(snap[f"tokenizer.embeds.{f}.weight"],
                                      np.unique(np.asarray(batch["non_seq"][f])))
    assert all(v.size == 0 for v in tracker.snapshot().values())  # reset


def test_push_rebuilds_the_trainers_params_bit_for_bit_and_matches_jax(trained):
    """base + push == the trainer's params, bit for bit (NaN entries, the
    layers the flax init never called, compare equal too); the push carries
    the JAX push's ids and, to the trainers' agreement, its rows and dense
    snapshot."""
    t = trained
    snap = t["tracker"].snapshot(reset=False)
    push = build_push(t["final"], snap, step=6)
    rebuilt = apply_push(t["base"], push, table_keys(t["tcfg"]))
    assert set(rebuilt) == set(t["final"])
    for k, v in t["final"].items():
        np.testing.assert_array_equal(rebuilt[k].numpy(), v.detach().numpy(), err_msg=k)
    jp = jpush.build_push(t["jfinal"], t["jtracker"].snapshot(reset=False), step=6)
    assert {_flax_table_key(k) for k in push["tables"]} == set(jp["tables"])
    for k, d in push["tables"].items():
        jd = jp["tables"][_flax_table_key(k)]
        np.testing.assert_array_equal(d["ids"].numpy(), jd["ids"], err_msg=k)
        np.testing.assert_allclose(d["rows"].numpy(), jd["rows"], **TOL, err_msg=k)
    jdense = params_from_flax(jpush.apply_push(t["jbase"], jp), t["tcfg"])
    for k, v in push["dense"].items():
        np.testing.assert_allclose(v.numpy(), jdense[k].numpy(), **TOL, err_msg=k)


def test_push_is_delta_sized_not_checkpoint_sized(trained):
    t = trained
    push = build_push(t["final"], t["tracker"].snapshot(reset=False), step=6)
    full = sum(v.numel() * v.element_size() for v in t["final"].values())
    assert push_nbytes(push) < full
    touched = sum(d["ids"].numel() for d in push["tables"].values())
    total_rows = sum(t["cfg"].vocab_size(f) for f in t["cfg"].non_seq_features)
    assert 0 < touched < total_rows
    jp = jpush.build_push(t["jfinal"], t["jtracker"].snapshot(reset=False), step=6)
    assert touched == sum(d["ids"].size for d in jp["tables"].values())


def test_push_npz_round_trip_and_a_mismatched_receiver_raises(tmp_path, trained):
    t = trained
    tables = table_keys(t["tcfg"])
    push = build_push(t["final"], t["tracker"].snapshot(reset=False), step=6)
    path = str(tmp_path / "push.npz")
    assert save_push(push, path) > 0
    loaded = load_push(path, t["base"], tables)
    assert loaded["step"] == 6
    for k, v in apply_push(t["base"], loaded, tables).items():
        np.testing.assert_array_equal(v.numpy(), apply_push(t["base"], push, tables)[k].numpy(), k)
    dense = next(k for k in t["base"] if k.startswith("blocks."))
    missing = {k: v for k, v in t["base"].items() if k != dense}
    with pytest.raises(ValueError, match="dense names differ"):
        load_push(path, missing, tables)
    reshaped = dict(t["base"], **{dense: torch.zeros(3)})
    with pytest.raises(ValueError, match=f"push {dense}: "):
        load_push(path, reshaped, tables)
    table = "tokenizer.item_embed.weight"
    narrow = dict(t["base"], **{table: t["base"][table][:, :-1]})
    with pytest.raises(ValueError, match=f"push {table}: rows"):
        load_push(path, narrow, tables)


def test_a_table_with_no_touched_rows_stays_out_of_the_push(tmp_path, trained):
    """A window that touched no item row ships no item table; the push
    still loads and applies, and that table keeps the receiver's rows."""
    t = trained
    tables = table_keys(t["tcfg"])
    item = "tokenizer.item_embed.weight"
    snap = dict(t["tracker"].snapshot(reset=False), **{item: np.zeros(0, np.int64)})
    push = build_push(t["final"], snap, step=6)
    assert item not in push["tables"] and item not in push["dense"]
    path = str(tmp_path / "no_item.npz")
    save_push(push, path)
    rebuilt = apply_push(t["base"], load_push(path, t["base"], tables), tables)
    assert torch.equal(rebuilt[item], t["base"][item])
    for k in push["tables"]:
        np.testing.assert_array_equal(rebuilt[k].numpy(), t["final"][k].detach().numpy(), k)


def test_bf16_rows_halve_the_bytes_within_tolerance(tmp_path, trained):
    t = trained
    snap = t["tracker"].snapshot(reset=False)
    exact = build_push(t["final"], snap, step=6)
    compact = build_push(t["final"], snap, step=6, rows_dtype=torch.bfloat16)
    jsnap = t["jtracker"].snapshot(reset=False)
    jcompact = jpush.build_push(t["jfinal"], jsnap, step=6, rows_dtype=jnp.bfloat16)
    for k, d in exact["tables"].items():
        rows = compact["tables"][k]["rows"]
        assert rows.dtype == torch.bfloat16 and rows.nbytes * 2 == d["rows"].nbytes
        np.testing.assert_allclose(rows.float().numpy(), d["rows"].numpy(), rtol=8e-3,
                                   atol=1e-6)
        jrows = np.asarray(jcompact["tables"][_flax_table_key(k)]["rows"], np.float32)
        np.testing.assert_allclose(rows.float().numpy(), jrows, rtol=8e-3, atol=1e-5)
    path = str(tmp_path / "bf16.npz")
    save_push(compact, path)
    loaded = load_push(path, t["base"], table_keys(t["tcfg"]))
    for k, d in compact["tables"].items():
        assert torch.equal(loaded["tables"][k]["rows"], d["rows"]), k


def test_engine_apply_push_serves_the_new_params_as_the_jax_engine(trained):
    t = trained
    cfg, tcfg = t["cfg"], t["tcfg"]
    push = build_push(t["final"], t["tracker"].snapshot(reset=False), step=6)
    eng = RankingInferenceEngine(tcfg, t["base"], max_seq_len=8, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in eng.state_dict().items()}
    fresh = RankingInferenceEngine(tcfg, t["final"], max_seq_len=8, device="cpu")
    user = {f: 1 for f in cfg.user_features + cfg.context_features}
    cands = [{f: 2 for f in cfg.item_features}]
    seqs = {cfg.sequence_features[0]: [1, 2, 3]}
    eng.update_session("s", seqs)
    eng.apply_push(push)  # sessions re-encoded under the new params
    assert {k: v.data_ptr() for k, v in eng.state_dict().items()} == ptrs
    got = eng.score_session("s", user, cands)
    fresh.update_session("s", seqs)
    want = fresh.score_session("s", user, cands)
    jeng = JaxEngine(cfg, jax.tree_util.tree_map(jnp.array, t["jbase"]), max_seq_len=8)
    jeng.update_session("s", seqs)
    jeng.apply_push(jpush.build_push(t["jfinal"], t["jtracker"].snapshot(reset=False),
                                     step=6))
    jgot = jeng.score_session("s", user, cands)
    for task in cfg.tasks:
        np.testing.assert_allclose(got[0][task], want[0][task], atol=1e-6)
        np.testing.assert_allclose(got[0][task], jgot[0][task], atol=1e-5)


def test_a_malformed_push_raises_and_leaves_the_engine_unchanged(trained):
    t = trained
    cfg, tcfg = t["cfg"], t["tcfg"]
    push = build_push(t["final"], t["tracker"].snapshot(reset=False), step=6)
    eng = RankingInferenceEngine(tcfg, t["base"], max_seq_len=8, device="cpu")
    user = {f: 1 for f in cfg.user_features + cfg.context_features}
    cands = [{f: 2 for f in cfg.item_features}]
    eng.update_session("s", {cfg.sequence_features[0]: [1, 2, 3]})
    before = eng.score_session("s", user, cands)
    snapshot = {k: v.clone() for k, v in eng.state_dict().items()}
    table = "tokenizer.item_embed.weight"
    dense = next(k for k in push["dense"] if k.startswith("blocks."))
    d = push["tables"][table]

    def with_table(**kw):
        return dict(push, tables=dict(push["tables"], **{table: dict(d, **kw)}))

    bad = [
        dict(push, dense=dict(push["dense"], **{dense: torch.zeros(3)})),
        dict(push, dense={k: v for k, v in push["dense"].items() if k != dense}),
        dict(push, dense=dict(push["dense"], **{dense: push["dense"][dense].double()})),
        with_table(rows=d["rows"][:, :-1]),
        with_table(ids=d["ids"].clone().fill_(cfg.vocab_size("item_id"))),
        with_table(ids=d["ids"][:-1]),
        dict(push, tables=dict(push["tables"], **{"blocks.0.q_s.weight": d})),
    ]
    for i, p in enumerate(bad):
        with pytest.raises(ValueError):
            eng.apply_push(p)
        for k, v in eng.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), snapshot[k].numpy(), f"case {i}: {k}")
    assert eng.score_session("s", user, cands) == before
