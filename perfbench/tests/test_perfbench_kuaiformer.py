"""The KuaiFormer cell's files on the CPU: its configuration against the
preset it stands for, the attention's allowed pairs against the program's
own masks, the FLOP count by hand, the inputs, and the runner through
``run_cell`` at a CPU size: its result line, the reference against the
program's step, and the faults and the control that ``correct`` has to
catch."""

import json
import os
import time

import pytest
import torch

from conftest import ROOT
from perfbench.reference.onetrans import Fp8Ops
from perfbench.run import load_cell, run_cell
from perfbench.workloads.retrieval_train import program_readings, reference_readings
from perfbench.yardstick.compare import NAMES, gaps
from perfbench.yardstick.retrieval_flops import (
    attention_pairs,
    attention_work,
    main_pairs,
    model_flops,
)
from perfbench.yardstick.retrieval_inputs import make_batches
from perfbench.yardstick.retrieval_shapes import param_specs

CELL = "kuaiformer_flagship.train_s2s_b1024"
CPU = torch.device("cpu")
SEED = 2**31 + 4242
TRAFFIC = {"kind": "retrieval_train", "mode": "seq2seq", "batch_size": 8, "placed_batches": 4,
           "warm_steps": 1, "profiled_steps": 1, "id_zipf": 1.1}


def small(cfg, **overrides):
    """``cfg`` at ``retrieval_small``'s widths (d 64, 2 layers, 4 heads, FFN
    128, 64 items: 2 groups of 16, 2 of 8, 16 raw), vocabularies of at most
    10,000 ids."""
    out = dict(cfg, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128, max_seq_len=64,
               compression_schedule=[[32, 16], [16, 8], [16, 1]], video_vocab_size=10_000,
               category_vocab_size=100, tag_vocab_size=500)
    out.update(overrides)
    return out


@pytest.fixture
def cell():
    info = load_cell(CELL)
    info["config"] = small(info["config"])
    info["traffic"] = dict(TRAFFIC)
    return info


def test_the_configuration_is_the_preset_but_its_reduced_fields():
    from recommend_tpu_torch.config import get_config

    f = json.load(open(os.path.join(ROOT, "perfbench/configs/kuaiformer_flagship.json")))
    assert f["preset"] == "retrieval_flagship" and set(f["overrides"]) == set(f["reduced"])
    assert f["reduced"] == ["dropout_rate", "sparse_scatter_budget"]
    assert set(f["reduced"]) <= set(f["assumed"])
    want = get_config("retrieval_flagship").to_dict()
    want.pop("__config_class__")
    want.pop("batch_size")
    got = f["config"]
    assert set(got) == set(want)
    assert {k for k in want if json.loads(json.dumps(want[k])) != got[k]} == set(f["reduced"])
    assert (got["dropout_rate"], got["sparse_scatter_budget"]) == (0.0, 0)
    # the published widths, whole
    assert (got["embed_dim"], got["num_layers"], got["num_heads"], got["ffn_dim"],
            got["max_seq_len"], got["num_query_tokens"], got["compression_layers"]) == (
                128, 6, 8, 512, 256, 4, 1)
    assert got["compression_schedule"] == [[128, 64], [80, 16], [48, 1]]
    assert (got["video_vocab_size"], got["category_vocab_size"], got["tag_vocab_size"]) == (
        10_000_000, 10_000, 50_000)


def test_the_parameters_are_the_towers():
    from recommend_tpu_torch.config import RetrievalConfig
    from recommend_tpu_torch.models.retrieval import RetrievalTower

    cfg = load_cell(CELL)["config"]
    with torch.device("meta"):
        model = RetrievalTower(RetrievalConfig.from_dict(cfg))
    want = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert [(n, s.shape) for n, s in param_specs(cfg).items()] == want


@pytest.mark.parametrize("schedule,k", [([[32, 16], [16, 8], [16, 1]], 4),
                                        ([[8, 4], [8, 1]], 2), ([[6, 3], [4, 1]], 3)])
def test_the_allowed_pairs_are_the_programs_masks(schedule, k):
    """Brute force: the pairs the program's own biases leave at 0, for full
    histories (the compression's padding mask, the interleaved mask)."""
    from recommend_tpu_torch.models.retrieval import _interleaved_causal_bias
    from recommend_tpu_torch.ops.attention import padding_mask_bias

    cfg = {"compression_schedule": schedule, "compression_layers": 2, "num_layers": 3,
           "num_query_tokens": k}
    got = attention_pairs(cfg)
    want = []
    for length, g in schedule:
        if g > 1:
            bias = padding_mask_bias(torch.ones((length // g, g), dtype=torch.bool))
            pairs = int((bias.expand(length // g, 1, g, g) == 0).sum()) // (length // g)
            want += [(length // g, g, pairs)] * 2
    t = sum(length // g for length, g in schedule)
    bias = _interleaved_causal_bias(torch.ones((1, t), dtype=torch.bool), k)
    want += [(1, t * (1 + k), int((bias == 0).sum()))] * 3
    assert [tuple(a) for a in got] == want
    assert main_pairs(t, k) == want[-1][2]


def test_the_cells_main_stack():
    cfg = load_cell(CELL)["config"]
    att = attention_pairs(cfg)
    assert [tuple(a) for a in att[:2]] == [(2, 64, 64 * 64), (5, 16, 256)]
    # 55 tokens: items 55·56/2 = 1,540 pairs; 4 queries each see t + 1 items and 4 queries
    assert tuple(att[-1]) == (1, 275, 1540 + 4 * (1540 + 55 * 4)) == (1, 275, 8580)
    assert len(att) == 2 + 6


def test_model_flops_by_hand():
    cfg = {"embed_dim": 8, "ffn_dim": 16, "num_heads": 2, "max_seq_len": 6,
           "num_query_tokens": 2, "compression_schedule": [[4, 2], [2, 1]],
           "compression_layers": 1, "num_layers": 1}
    d, f = 8, 16
    # fusion MLP: 6 history items + 2 next items, 5d -> 2d -> d
    macs = 8 * (40 * 16 + 16 * 8)
    # compression: 2 groups of 2, each 2 tokens and 4 pairs
    macs += 2 * 2 * (4 * d * d + 3 * d * f) + 2 * 2 * 4 * d
    # main: T = 2 + 2 = 4 tokens, 4·3 = 12 slots; pairs 10 + 2·(10 + 4·2) = 46
    macs += 12 * (4 * d * d + 3 * d * f) + 2 * 46 * d
    # the logits: 2 positions x 2 interests x 5 columns
    macs += 2 * 2 * 5 * d
    assert model_flops(cfg, 5, training=False) == 2 * macs
    assert model_flops(cfg, 5) == 6 * macs
    w = attention_work(cfg, 3)
    # Dh 4, 2 heads, batch 3: compression 2 rows of 4 pairs, main 46 pairs
    assert w["flops"] == 12 * 4 * (2 * 4 + 46) * 2 * 3
    assert w["bytes"] == 8 * (2 * 2 + 12) * 2 * 4 * 3 * 2
    with pytest.raises(ValueError):
        model_flops(cfg, 5, mode="single")


def test_the_batches_are_full_and_skewed():
    cfg = small(load_cell(CELL)["config"])
    a = make_batches(cfg, TRAFFIC, SEED, CPU)
    b = make_batches(cfg, TRAFFIC, SEED, CPU)
    c = make_batches(cfg, TRAFFIC, SEED + 1, CPU)
    assert len(a) == TRAFFIC["placed_batches"]
    for x, y, z in zip(a, b, c):
        assert bool(x["history_valid"].all()) and x["history_valid"].shape == (8, 64)
        assert all(v.shape == (8, 64) for v in x["history"].values())
        assert all(v.shape == (8,) for v in x["target"].values())
        assert torch.equal(x["history"]["video_id"], y["history"]["video_id"])
        assert not torch.equal(x["history"]["video_id"], z["history"]["video_id"])
        d = x["history"]["duration"]
        assert d.dtype == torch.float32 and float(d.min()) >= 0 and float(d.max()) < 300
        assert int(x["history"]["timestamp"].max()) < cfg["time_buckets"]
        assert int(x["history"]["video_id"].max()) < cfg["video_vocab_size"]
    # the top video (rank 1, id 0) is the most popular, at its Zipf probability
    top = 1 / sum(r ** -1.1 for r in range(1, 10_001))
    pop = torch.cat([x["history_popularity"].reshape(-1) for x in a])
    ids = torch.cat([x["history"]["video_id"].reshape(-1) for x in a])
    assert float(pop.max()) == pytest.approx(top, rel=1e-5)
    assert bool((pop[ids == 0] == pop.max()).all()) and int((ids == 0).sum()) > 0


def _run(info, seed=SEED):
    return run_cell(info, seed, 0.5, False, CPU, "cpu", time.time())


def test_result_line(cell):
    info = {**cell, "config": {**cell["config"], "compute_dtype": "float32"}}
    res = _run(info)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "where",
                        "checks"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(info["limits"])
    assert set(info["limits"]) >= {"grad_gap", "rows_gap", "change_gap"}
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    # float32 on both sides: the program's step is the reference's
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), res["checks"]
    assert res["correct"] is True
    json.dumps(res)


def test_the_runner_returns_what_run_cell_and_the_readers_read(cell):
    from perfbench.workloads import retrieval_train

    out = retrieval_train.run(cell["config"], cell["traffic"], SEED, 0.2, False, CPU,
                              time.time())
    assert {"setup_s", "steps", "seconds", "examples", "failed", "flops_per_step",
            "memory_peak_bytes", "numbers", "program", "reference"} <= set(out)
    assert {"grad_at", "change_worst", "change_at", *NAMES} <= set(out["numbers"])
    assert out["examples"] == out["steps"] * 8
    assert out["flops_per_step"] == model_flops(cell["config"], 8) * 8


def test_same_seed_same_inputs(cell):
    cfg = {**cell["config"], "compute_dtype": "float32"}
    a = reference_readings(cfg, TRAFFIC, SEED, CPU)
    b = reference_readings(cfg, TRAFFIC, SEED, CPU)
    c = reference_readings(cfg, TRAFFIC, SEED + 1, CPU)
    assert a == b and a["loss"] != c["loss"]


def test_bf16_program_against_the_reference(cell):
    g = gaps(program_readings(cell["config"], TRAFFIC, SEED, CPU),
             reference_readings(cell["config"], TRAFFIC, SEED, CPU))
    # the same rows move on both sides; the norms differ by rounding
    assert g["rows_gap"] == 0 and all(0 < g[n] < 0.1 for n in NAMES if n != "rows_gap"), g


def test_the_control_reads_far_above_the_program(cell):
    """float8 products in the program's place read ``grad_gap`` at three
    times the bfloat16 program's or more."""
    cfg = cell["config"]
    ref = reference_readings(cfg, TRAFFIC, SEED, CPU)
    ctrl = gaps(reference_readings(cfg, TRAFFIC, SEED, CPU, Fp8Ops()), ref)
    prog = gaps(program_readings(cfg, TRAFFIC, SEED, CPU), ref)
    assert ctrl["grad_gap"] >= 3 * prog["grad_gap"], (prog, ctrl)


def _unchanged(monkeypatch):
    from recommend_tpu_torch.training import trainer
    from recommend_tpu_torch.training.optimizer import RetrievalOptimizer

    def nothing(self, params, grads, state):
        state["count"] += 1

    monkeypatch.setattr(RetrievalOptimizer, "step", nothing)
    monkeypatch.setattr(trainer.RetrievalTrainer, "_apply_sparse_updates",
                        lambda self, *a, **k: torch.zeros((), dtype=torch.long))


def _half_batch(monkeypatch):
    from recommend_tpu_torch.training import trainer

    loss = trainer.seq2seq_in_batch_loss

    def half(interests, items, pop, valid, **kw):
        b = interests.shape[0] // 2
        return loss(interests[:b], items[:b], None if pop is None else pop[:b], valid[:b], **kw)

    monkeypatch.setattr(trainer, "seq2seq_in_batch_loss", half)


def _wrong_lr(monkeypatch):
    from recommend_tpu_torch.training.optimizer import RetrievalOptimizer

    init = RetrievalOptimizer.__init__

    def scaled(self, *a, **k):
        init(self, *a, **k)
        lr = self.lr
        self.lr = lambda count: 1.25 * lr(count)

    monkeypatch.setattr(RetrievalOptimizer, "__init__", scaled)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _wrong_lr],
                         ids=["unchanged", "half_batch", "wrong_lr"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """The whole run but the look for a card, with the timed path broken
    underneath: a state left unchanged, half of the batch, a dense learning
    rate a quarter too high."""
    info = {**cell, "config": {**cell["config"], "compute_dtype": "float32",
                               "warmup_steps": 1}}
    assert _run(info)["correct"]
    fault(monkeypatch)
    res = _run(info)
    assert res["correct"] is False, res["checks"]


def test_the_span_phase_on_the_runs_own_trainer(cell):
    """The span phase (``yardstick/retrieval_spans.py``) on the CPU: the
    phases and the tower's spans per step, and the readers of its host
    times; device times are a card's."""
    from perfbench.run import reader
    from perfbench.workloads.retrieval_train import build
    from perfbench.yardstick.retrieval_spans import run_phase
    from perfbench.yardstick.spans import SPAN_STEPS

    trainer, state, batches = build(cell["config"], cell["traffic"], SEED, CPU)
    spans, state = run_phase(trainer, state, batches, 0, CPU)
    assert spans["steps"] == 2 * SPAN_STEPS and state.step == 5 * SPAN_STEPS
    assert set(spans["host_ms"]) == {"train_step", "forward", "compression", "tower_blocks",
                                     "in_batch_loss", "backward", "optimizer",
                                     "sparse_update"}
    assert spans["counts"]["sparse_dropped_rows"] == 0
    assert spans["profiled"]["steps"] == SPAN_STEPS
    ctx = {"spans": spans, "profile": {"steps": 1}}
    assert reader("step_host_ms.train").read(ctx) == spans["host_ms"]["train_step"]
    for name in ("compression_ms.train", "tower_blocks_ms.train", "in_batch_loss_ms.train"):
        assert reader(name).read(ctx) is None  # no CUDA events on the CPU
    # a program without the tower's spans (the parent's) reads None, and raises nothing
    assert reader("compression_ms.train").read({"spans": {"device_ms": {"train_step": 1.0}}}) \
        is None
