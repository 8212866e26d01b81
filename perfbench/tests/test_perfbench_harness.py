"""The harness on the cells cut to a CPU size, through the program's plain
CPU paths: the result line, the reference against the program's step, and
the faults and the control that ``correct`` has to catch."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, SMALL_TRAFFIC, small
from perfbench.reference.onetrans import Fp8Ops
from perfbench.run import load_cell, run_cell
from perfbench.workloads.train import program_readings, reference_readings
from perfbench.yardstick.compare import NAMES, gaps

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # seeds may pass 32 signed bits


def _run(info, seed=SEED):
    return run_cell(info, seed, 0.5, False, CPU, "cpu", time.time())


def test_result_line(cell):
    info = {**cell, "config": small(cell["config"], use_mixed_precision=False)}
    res = _run(info)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "where",
                        "checks"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(info["limits"])
    assert set(info["limits"]) >= {"grad_gap", "rows_gap", "change_gap"}
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    # float32 on both sides: the program's step is the reference's
    assert all(c["value"] < 1e-5 for c in res["checks"].values()), res["checks"]
    assert res["correct"] is True
    json.dumps(res)


def test_same_seed_same_inputs(cell):
    cfg = small(cell["config"], use_mixed_precision=False)
    a = reference_readings(cfg, SMALL_TRAFFIC, SEED, CPU)
    b = reference_readings(cfg, SMALL_TRAFFIC, SEED, CPU)
    c = reference_readings(cfg, SMALL_TRAFFIC, SEED + 1, CPU)
    assert a == b and a["loss"] != c["loss"]


def test_batches_are_full_and_skewed():
    """Every sequence full (no padding), the ids Zipf-skewed over the whole
    vocabulary and hashed over it, every seed the same shapes."""
    from perfbench.yardstick.batches import make_batches, zipf_ids

    cfg = small(load_cell("onetrans_l.train_s1190")["config"])
    a = make_batches(cfg, SMALL_TRAFFIC, SEED, CPU)
    b = make_batches(cfg, SMALL_TRAFFIC, SEED + 1, CPU)
    assert len(a) == SMALL_TRAFFIC["placed_batches"]
    for x, y in zip(a, b):
        for g in x:
            assert {k: v.shape for k, v in x[g].items()} == {k: v.shape for k, v in y[g].items()}
        assert all(bool(v.all()) for v in x["seq_valid"].values())
        assert all(v.shape == (16, 24) for v in x["sequences"].values())
    gen = torch.Generator().manual_seed(0)
    ids = zipf_ids((200_000,), 1000, 1.1, gen, CPU)
    counts = torch.bincount(ids, minlength=1000)
    assert int(ids.min()) >= 0 and int(ids.max()) < 1000 and int((counts > 0).sum()) > 900
    # rank 1 (id 0) and rank 2 (id 2654435761 mod 1000) in the ratio 2^1.1
    assert float(counts[0] / counts[2654435761 % 1000]) == pytest.approx(2 ** 1.1, rel=0.05)
    assert float(counts[0]) / len(ids) == pytest.approx(
        1 / sum(r ** -1.1 for r in range(1, 1001)), rel=0.03)


def test_bf16_program_against_the_reference(cell):
    cfg = small(cell["config"])
    g = gaps(program_readings(cfg, SMALL_TRAFFIC, SEED, CPU),
             reference_readings(cfg, SMALL_TRAFFIC, SEED, CPU))
    # the same rows move on both sides; the norms differ by rounding
    assert g["rows_gap"] == 0 and all(0 < g[n] < 0.1 for n in NAMES if n != "rows_gap"), g


def test_the_control_reads_far_above_the_program(cell):
    """float8 products in the program's place read ``grad_gap`` at three
    times the bfloat16 program's or more, at this size as at the cell's
    own (``control.py`` reads that on the card)."""
    cfg = small(cell["config"])
    ref = reference_readings(cfg, SMALL_TRAFFIC, SEED, CPU)
    ctrl = gaps(reference_readings(cfg, SMALL_TRAFFIC, SEED, CPU, Fp8Ops()), ref)
    prog = gaps(program_readings(cfg, SMALL_TRAFFIC, SEED, CPU), ref)
    assert ctrl["grad_gap"] >= 3 * prog["grad_gap"], (prog, ctrl)


def _unchanged(monkeypatch):
    from recommend_tpu_torch.training import ranking_trainer
    from recommend_tpu_torch.training.optimizer import RankingOptimizer

    monkeypatch.setattr(RankingOptimizer, "step", lambda self, p, g, s, norm=None: norm)
    monkeypatch.setattr(ranking_trainer.RankingTrainer, "_apply_sparse_updates",
                        lambda self, *a, **k: torch.zeros((), dtype=torch.long))


def _half_batch(monkeypatch):
    from recommend_tpu_torch.training import ranking_trainer

    loss = ranking_trainer.multi_task_bce_loss

    def half(logits, labels):
        b = next(iter(labels.values())).shape[0] // 2
        return loss({t: v[:b] for t, v in logits.items()}, {t: v[:b] for t, v in labels.items()})

    monkeypatch.setattr(ranking_trainer, "multi_task_bce_loss", half)


def _wrong_lr(monkeypatch):
    from recommend_tpu_torch.training.optimizer import RankingOptimizer

    init = RankingOptimizer.__init__

    def scaled(self, *a, **k):
        init(self, *a, **k)
        self.dense_lr = 1.25 * self.dense_lr

    monkeypatch.setattr(RankingOptimizer, "__init__", scaled)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _wrong_lr],
                         ids=["unchanged", "half_batch", "wrong_lr"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """The whole run but the look for a card, with the timed path broken
    underneath (the two faults a one-card training cell can have, and a
    dense learning rate a quarter too high)."""
    info = {**cell, "config": small(cell["config"], use_mixed_precision=False)}
    assert _run(info)["correct"]
    fault(monkeypatch)
    res = _run(info)
    assert res["correct"] is False, res["checks"]


def test_the_command_needs_a_card_and_the_program(tmp_path):
    """Without the program beside it (a directory of BENCHMARK.json and
    perfbench/ alone) the command exits non-zero with no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "onetrans_s.train_b2048", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ""}, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.chip
def test_a_cell_on_the_card():
    """A short run of each cell on the card: correct, and every metric read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("onetrans_s.train_b2048", "onetrans_l.train_s1190"):
        for trace in (0, 1):
            proc = subprocess.run(
                [sys.executable, "perfbench/run.py", "--workload", name, "--seed", str(SEED),
                 "--seconds", "2", "--trace", str(trace)], cwd=ROOT, capture_output=True,
                text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-3000:]
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            info = load_cell(name)
            want = {m["name"] for m in info["per_layer" if trace else "end_to_end"]}
            assert res["correct"] and set(res["metrics"]) == want, res
            assert all(math.isfinite(m["value"]) for m in res["metrics"].values())
