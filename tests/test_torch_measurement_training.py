"""The port's training measurement scripts beside the JAX scripts they port,
both run in this process on the CPU at small sizes:

- ``examples_torch/flagship_bench.py``: its ``main`` against the JAX
  script's ``main`` at ``--steps 2``, with both scripts' ``get_config``
  narrowing ``retrieval_flagship`` to ``TINY_FLAGSHIP`` (the 10M-row table
  and 2,000 users' draws over it are the card's size; float32, since the
  CPU has no bf16 x bf16 dot). The same report keys, both arms' keys
  (``sparse_dropped_rows`` only with the scatter budget), finite losses,
  none of the budget's rows dropped.
- ``examples_torch/scaling_bench.py``: its ``main`` at ``--virtual 2
  --tiny`` (two gloo ranks, a process group each world size) against the
  JAX script's ``main`` at ``--tiny`` on two of the virtual CPU devices.
  The same world sizes, keys and printed lines; efficiency 1.0 at world 1.
"""

import json

import jax
import numpy as np
import torch

import recommend_tpu.config as jconfig
from examples_torch import flagship_bench, scaling_bench
from tests.test_torch_examples_jax import _jax_main as jax_main

torch.set_num_threads(1)

TINY_FLAGSHIP = dict(
    video_vocab_size=2000, batch_size=16, embed_dim=32, num_layers=1, num_heads=2,
    ffn_dim=64, max_seq_len=16, compression_schedule=((8, 4), (8, 1)),
    compute_dtype="float32",
)


def narrowed(get_config):
    def get(name, **overrides):
        if name == "retrieval_flagship":
            overrides = {**overrides, **TINY_FLAGSHIP}
        return get_config(name, **overrides)

    return get


def test_flagship_bench_reports_what_the_jax_script_reports(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(jconfig, "get_config", narrowed(jconfig.get_config))
    monkeypatch.setattr(flagship_bench, "get_config", narrowed(flagship_bench.get_config))
    jax_main(monkeypatch, "flagship_bench", ["--steps", "2", "--output",
                                             str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr().out
    assert flagship_bench.main(["--steps", "2", "--output", str(tmp_path / "port.json"),
                                "--num_users", "200", "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want) == {"device", "flagship_budget_16384", "flagship_budget_off",
                                     "budget_speedup"}
    for arm in ("flagship_budget_16384", "flagship_budget_off"):
        assert set(got[arm]) == set(want[arm]), arm
        assert np.isfinite(got[arm]["loss"]) and got[arm]["examples_per_s"] > 0
    assert got["flagship_budget_16384"]["sparse_dropped_rows"] == 0
    assert "sparse_dropped_rows" not in got["flagship_budget_off"]
    progress = lambda out: [line.split("] ", 1)[1] for line in out.splitlines()  # noqa: E731
                            if "] measuring " in line]
    assert progress(port_out) == progress(jax_out)


def test_scaling_bench_reports_what_the_jax_script_reports(monkeypatch, capsys):
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    jax_main(monkeypatch, "scaling_bench", ["--tiny", "--steps", "2"])
    jax_out = capsys.readouterr().out
    assert scaling_bench.main(["--virtual", "2", "--tiny", "--steps", "2"]) == 0
    port_out = capsys.readouterr().out
    want, got = (json.loads(out.strip().splitlines()[-1]) for out in (jax_out, port_out))
    assert got["model"] == want["model"] == "ranking"
    assert set(got["results"]) == set(want["results"]) == {"1", "2"}
    for n, r in got["results"].items():
        assert set(r) == set(want["results"][n])
        assert r["examples_per_s"] > 0
    assert got["results"]["1"]["scaling_efficiency"] == 1.0
    lines = lambda out: [line.split(":")[0] for line in out.splitlines()  # noqa: E731
                         if "chip(s):" in line]
    assert lines(port_out) == lines(jax_out) == ["1 chip(s)", "2 chip(s)"]
