"""The recorder of spans and counters (``recommend_tpu_torch/utils/profiling.py``)
inside ``RetrievalTrainer._train_step``, on the CPU with a narrow tower and
row-wise sparse updates:

- a step is ``train_step`` over ``forward``, ``backward``, ``optimizer``
  and ``sparse_update`` (the ranking trainer's phases, by name), in every
  mode;
- the tower's ``compression`` and ``tower_blocks`` and the
  ``in_batch_loss`` lie inside ``forward``;
- ``sparse_dropped_rows`` counts 0 with no scatter budget and the rows a
  budget below the step's valid rows drops (the step's own metric);
- off, nothing is recorded, and the state after 2 steps is bitwise the same
  with the recorder on and off.
"""

import contextlib

import pytest
import torch

from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data import pipeline, synthetic
from recommend_tpu_torch.training.trainer import RetrievalTrainer
from recommend_tpu_torch.utils import profiling

PHASES = ("forward", "backward", "optimizer", "sparse_update")
TOWER = ("compression", "tower_blocks", "in_batch_loss")
BATCH = 4


def _cfg(budget=0):
    return get_config(
        "retrieval_small", embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64,
        max_seq_len=16, compression_schedule=((8, 4), (8, 1)), video_vocab_size=200,
        category_vocab_size=20, tag_vocab_size=50, dropout_rate=0.0, warmup_steps=1,
        batch_size=BATCH, use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
        sparse_scatter_budget=budget)


def _run(cfg, steps, on, mode="seq2seq"):
    """(state after ``steps`` steps, the steps' metrics, the recorder's
    export); every call starts from the same parameters and batches."""
    data = synthetic.make_retrieval_data(cfg, num_users=8, num_videos=150, seed=0)
    trainer = RetrievalTrainer(cfg, mode=mode, device="cpu")
    batches = [trainer._put_batch(b) for b in
               pipeline.retrieval_batches(data, cfg, BATCH, seed=0, num_epochs=1)][:steps]
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    metrics = []
    with profiling.recording() if on else contextlib.nullcontext():
        for b in batches:
            state, m = trainer._train_step(state, b, gen)
            metrics.append(m)
    return state, batches, metrics, profiling.export()


@pytest.mark.parametrize("mode", ["seq2seq", "single", "masked"])
def test_the_step_is_a_tree_of_phase_spans(mode):
    _, _, _, rec = _run(_cfg(), 2, True, mode)
    spans = rec["spans"]
    names = [s["name"] for s in spans]
    per_step = ["train_step", "forward", "compression", "tower_blocks", "in_batch_loss",
                *PHASES[1:]]
    assert names == per_step * 2
    n = len(per_step)
    for i, s in enumerate(spans):
        root = i - i % n
        assert s["step"] == i // n
        if s["name"] in TOWER:
            assert s["parent"] == root + 1  # forward
        else:
            assert s["parent"] == (None if i == root else root)
        parent = spans[s["parent"]] if s["parent"] is not None else s
        assert parent["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"]
        assert s["host_end_ns"] <= parent["host_end_ns"]


def test_the_phases_carry_the_ranking_trainers_names():
    """Both trainers run the one step of ``training/base.py``, whose spans
    are the phases."""
    import inspect

    from recommend_tpu_torch.training.base import TrainerBase
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    src = inspect.getsource(TrainerBase._train_step)
    assert all(f'span("{p}")' in src for p in PHASES)
    for cls in (RankingTrainer, RetrievalTrainer):
        assert cls._train_step is TrainerBase._train_step, cls.__name__


@pytest.mark.parametrize("budget", [0, 40])
def test_sparse_dropped_rows(budget):
    cfg = _cfg(budget)
    state, batches, metrics, rec = _run(cfg, 2, True)
    got = [c for c in rec["counts"] if c["name"] == "sparse_dropped_rows"]
    assert [c["step"] for c in got] == [0, 1]
    for c, b, m in zip(got, batches, metrics):
        assert c["span"] is None or rec["spans"][c["span"]]["name"] == "train_step"
        valid = int(b["history_valid"].sum()) + int(b["history_valid"][:, -7:].sum()) + BATCH
        if budget == 0:
            assert c["value"] == 0 and "sparse_dropped_rows" not in m
        else:
            assert budget < valid and c["value"] == valid - budget > 0
            assert c["value"] == int(m["sparse_dropped_rows"])
    lookups = {c["key"] for c in rec["counts"] if c["name"] == "sparse_lookups"}
    assert lookups == {"embed.tables.video_id.weight", "embed.tables.category.weight",
                       "embed.tables.tag.weight"}


def test_off_records_nothing_and_on_changes_no_bit():
    off, _, _, nothing = _run(_cfg(), 2, False)
    assert nothing["spans"] == [] and nothing["counts"] == []
    on, _, _, rec = _run(_cfg(), 2, True)
    assert rec["spans"] and not profiling.is_recording()
    assert on.step == off.step == 2
    for n in off.params:
        assert torch.equal(on.params[n], off.params[n]), n
    for n, t in off.opt_state[1].items():
        assert torch.equal(on.opt_state[1][n], t), n
    for moment in ("mu", "nu"):
        for n, t in off.opt_state[0][moment].items():
            assert torch.equal(on.opt_state[0][moment][n], t), n
