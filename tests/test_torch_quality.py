"""``quality_torch.py``, the port's ML-1M replica quality run, at its small
scale on the CPU: it trains 120 steps, evaluates leave-one-out against the
popularity baseline and writes its JSON; run again on the same checkpoint
directory it resumes at the last step and gives the same metrics, bit for
bit. (The full-scale numbers come from the card: ``PERF.md``.)"""

import json

import numpy as np
import torch

import quality_torch

torch.set_num_threads(1)


def test_small_run_writes_its_metrics_and_resumes(tmp_path):
    out, ckpt = tmp_path / "q.json", tmp_path / "ckpt"
    args = ["--scale", "small", "--device", "cpu", "--checkpoint-dir", str(ckpt)]
    assert quality_torch.main(args + ["--output", str(out)]) == 0
    first = json.loads(out.read_text())
    run = first["ml1m_replica"]
    assert first["device"] == "cpu" and first["card"].startswith("not measured")
    assert run["scale"] == "small" and run["train_steps"] == 120 and run["start_step"] == 0
    assert run["steps_per_s"] > 0
    ks = (1, 5, 10, 50, 100)
    assert set(run["metrics"]) == ({f"recall@{k}" for k in ks} | {f"ndcg@{k}" for k in ks}
                                   | {"mrr", "map"})
    recalls = [run["metrics"][f"recall@{k}"] for k in ks]
    assert all(0 <= r <= 1 for r in recalls) and np.all(np.diff(recalls) >= 0)
    assert set(run["popularity_baseline"]) == {f"recall@{k}" for k in ks}
    assert [int(p.stem.split("_")[1]) for p in sorted(ckpt.glob("ckpt_*.pt"))] == [120]

    again = tmp_path / "again.json"
    assert quality_torch.main(args + ["--output", str(again)]) == 0
    second = json.loads(again.read_text())["ml1m_replica"]
    assert second["start_step"] == 120
    assert second["metrics"] == run["metrics"]
    assert second["popularity_baseline"] == run["popularity_baseline"]
