"""The port's mesh measurement entry points beside the JAX ones, on the CPU:

- ``examples_torch/lookup_bench.py``: its ``main`` at ``--devices 2
  --device cpu`` (two gloo ranks) against the JAX script's ``main`` on a
  (1, 2) mesh of the virtual CPU devices, at a small table and batch. The
  ids are drawn alike, so the unique count and the analytic traffic model
  agree in value (JAX rounds to 0.01 MB); the wall times carry the same
  keys.
- ``graft_entry_torch.dryrun_multichip(2)`` on two gloo ranks
  (``tests/torch_parallel_ranks.run_ranks``): a (1, 2) mesh, both steps
  finite and alike on every rank, the item table split over ``model``;
  and the JAX ``dryrun_multichip(2)`` prints the same two lines.
"""

import json
import re

import jax
import numpy as np
import torch

import __graft_entry__ as jax_graft
from examples_torch import lookup_bench
from tests import torch_parallel_cases as cases
from tests.test_torch_examples_jax import _jax_main as jax_main
from tests.torch_parallel_ranks import run_ranks

torch.set_num_threads(1)

SMALL = ["--devices", "2", "--vocab", "4096", "--batch", "1024", "--iters", "2"]


def test_lookup_bench_reports_what_the_jax_script_reports(monkeypatch, capsys):
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    jax_main(monkeypatch, "lookup_bench", SMALL)
    want = json.loads(capsys.readouterr().out)
    assert lookup_bench.main([*SMALL, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    for key in ("devices", "vocab", "dim", "batch", "unique_ids"):
        assert got[key] == want[key], key
    assert set(got["ici_model_mb_per_chip"]) == set(want["ici_model_mb_per_chip"])
    for key, mb in got["ici_model_mb_per_chip"].items():
        assert abs(mb - want["ici_model_mb_per_chip"][key]) <= 0.005, key
    assert set(got["wall_ms"]) == set(want["wall_ms"])
    assert all(np.isfinite(v) and v > 0 for v in got["wall_ms"].values())
    assert "gloo" in got["note"]


def test_dryrun_multichip_runs_on_two_gloo_ranks(capsys):
    jax_graft.dryrun_multichip(2)
    jax_lines = [re.sub(r"loss=\S+", "loss=", line)
                 for line in capsys.readouterr().out.splitlines()]
    results = run_ranks(2, cases.graft_dryrun, {"n": 2})
    assert results[0] == results[1]
    r = results[0]
    assert r["mesh"] == {"data": 1, "model": 2}
    assert np.isfinite(r["loss"]) and np.isfinite(r["sparse_loss"])
    assert r["item_table_rows_a_rank"] == 16_384 // 2
    assert [line.split(":")[0] for line in jax_lines] == ["dryrun_multichip(2)"] * 2
    assert "mesh={'data': 1, 'model': 2}" in jax_lines[0]
    assert "sparse row-sharded table [16384 rows]" in jax_lines[1]
