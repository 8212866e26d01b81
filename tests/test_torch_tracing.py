"""The recorder of spans and counters (``recommend_tpu_torch/utils/profiling.py``)
inside ``RankingTrainer._train_step``, on the CPU with a narrow trainer and
sparse updates on:

- the span tree of a step and its step number, each span's host interval
  inside its parent's;
- off, nothing is recorded, and the state after 2 steps is bitwise the same
  with the recorder on and off;
- each table's ``sparse_lookups`` and ``sparse_unique_rows`` are the counts
  of ``torch.unique`` over its in-range ids;
- under a CPU ``torch.profiler`` each span is a ``user_annotation`` inside
  its step's ``train_step_<i>`` range;
- ``ops/flash_attention.LAUNCHES`` is registered, not copied.
"""

import contextlib
import json

import pytest
import torch

from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data import pipeline, synthetic
from recommend_tpu_torch.ops import flash_attention as fa
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from recommend_tpu_torch.utils import profiling

PHASES = ("forward", "backward", "optimizer", "sparse_update")


def _cfg(mode="rowwise"):
    return get_config(
        "ranking_base", embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, num_ns_tokens=4,
        pyramid_ratios=(0.5, 0.25), feature_embed_dim=8, seq_item_feature_dim=8,
        task_head_hidden=8, dropout_rate=0.0, batch_size=4, use_sparse_embedding_updates=True,
        sparse_update_mode=mode, feature_vocab_sizes=tuple(
            (f, min(v, 50)) for f, v in get_config("ranking_base").feature_vocab_sizes))


def _run(cfg, steps, on, start=0):
    """(trainer, state after ``steps`` steps, the placed batches, the
    recorder's export); every call starts from the same parameters."""
    data = synthetic.make_ranking_data(cfg, num_samples=4 * steps, max_seq_per_feature=8,
                                       seed=0)
    trainer = RankingTrainer(cfg, device="cpu")
    batches = [trainer._put_batch(b) for b in
               pipeline.ranking_batches(data, cfg, 4, seed=0, num_epochs=1)][:steps]
    state = trainer.init_state(seed=0)._replace(step=start)
    with profiling.recording() if on else contextlib.nullcontext():
        for b in batches:
            state, _ = trainer._train_step(state, b)
    return trainer, state, batches, profiling.export()


def _assert_equal(a, b, where="opt_state"):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), where


def test_the_step_is_a_tree_of_phase_spans():
    _, state, _, rec = _run(_cfg(), 2, True, start=5)
    spans = rec["spans"]
    assert [s["name"] for s in spans] == (["train_step", *PHASES] * 2)
    assert [s["step"] for s in spans] == [5] * 5 + [6] * 5 and state.step == 7
    for i, s in enumerate(spans):
        root = i - i % 5
        assert s["parent"] == (None if i == root else root)
        parent = spans[root]
        assert parent["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"]
        assert s["host_end_ns"] <= parent["host_end_ns"]
        assert "device_start_ms" not in s  # no card: host times alone
    names = {c["name"] for c in rec["counts"]}
    # host syncs and the activations' bytes are read on a card only
    assert names == {"sparse_lookups", "sparse_unique_rows"}
    sparse = [s for s in range(10) if spans[s]["name"] == "sparse_update"]
    assert {c["span"] for c in rec["counts"]} == set(sparse)
    assert profiling.export() == {"spans": [], "counts": [],
                                  "registered": rec["registered"]}


@pytest.mark.parametrize("mode", ["rowwise", "exact"])
def test_off_records_nothing_and_on_changes_no_bit(mode):
    assert profiling.span("a") is profiling.span("b")  # off: one shared null context
    _, off, _, nothing = _run(_cfg(mode), 2, False)
    assert nothing["spans"] == [] and nothing["counts"] == []
    _, on, _, rec = _run(_cfg(mode), 2, True)
    assert rec["spans"] and not profiling.is_recording()
    assert on.step == off.step == 2
    for n in off.params:
        assert torch.equal(on.params[n], off.params[n]), n
    _assert_equal(on.opt_state, off.opt_state)


def test_sparse_counts_are_the_unique_in_range_ids_of_each_table():
    cfg = _cfg()
    trainer, _, batches, rec = _run(cfg, 2, True)
    for step, b in enumerate(batches):
        want = {}
        for f, table in trainer._ns_tables.items():
            want[table] = b["non_seq"][f].reshape(-1)
        seqs = trainer._seq_names_of(b)
        ids = torch.cat([b["sequences"][sf][b["seq_valid"][sf]] for sf in seqs])
        assert ids.numel() < sum(b["sequences"][sf].numel() for sf in seqs)  # padding
        want[trainer._item_table] = ids
        got = {(c["name"], c["key"]): c["value"] for c in rec["counts"] if c["step"] == step}
        assert {k for _, k in got} == set(want)
        for table, t in want.items():
            vocab = dict(trainer.model.named_parameters())[table].shape[0]
            t = t[(t >= 0) & (t < vocab)]
            uniq, counts = torch.unique(t, return_counts=True)
            assert got[("sparse_lookups", table)] == int(counts.sum()), table
            assert got[("sparse_unique_rows", table)] == len(uniq), table


def test_spans_are_user_annotations_inside_their_step_range(tmp_path):
    cfg = _cfg()
    trainer, state, batches, _ = _run(cfg, 2, False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, profiling.recording():
        for b in batches:
            state, _ = trainer._train_step(state, b)
    rec = profiling.export()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    steps = {e["name"]: e for e in ann if e["name"].startswith("train_step_")}
    assert set(steps) == {"train_step_2", "train_step_3"}
    for s in rec["spans"]:
        if s["name"] == "train_step":
            continue
        root = steps[f"train_step_{s['step']}"]
        inside = [e for e in ann if e["name"] == s["name"] and e["tid"] == root["tid"]
                  and root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]]
        assert len(inside) == 1, s


def test_launches_are_registered_not_copied():
    assert profiling.RECORDER.registered["band_attention_launches"] is fa.LAUNCHES
    with profiling.recording():
        fa.LAUNCHES["band_attn_bh_fwd"] += 3
    try:
        assert profiling.export()["registered"]["band_attention_launches"] == fa.LAUNCHES
    finally:
        fa.LAUNCHES["band_attn_bh_fwd"] -= 3


def test_the_recorder_outside_a_step():
    """A block already on stays on; counts outside a step carry no step;
    export refuses an open span."""
    with profiling.recording():
        with profiling.recording():
            profiling.count("n", 2, key="k")
        assert profiling.is_recording()
        with profiling.span("outer"):
            profiling.count("m", torch.tensor(3))
            with pytest.raises(RuntimeError, match="outer"):
                profiling.export()
    rec = profiling.export()
    assert rec["spans"][0]["name"] == "outer" and rec["spans"][0]["step"] is None
    assert rec["counts"] == [{"name": "n", "key": "k", "step": None, "span": None, "value": 2},
                             {"name": "m", "key": None, "step": None, "span": 0, "value": 3}]
