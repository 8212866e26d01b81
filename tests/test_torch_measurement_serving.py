"""The port's serving measurement scripts beside the JAX scripts they port,
both run in this process on the CPU at small sizes:

- ``examples_torch/flagship_serving_bench.py``: its ``main`` at a 3,000-item
  corpus against the JAX script's three phase functions at the same corpus
  (the JAX ``main`` runs each phase in a subprocess and takes no small
  flag, so its functions are called). The same JSON keys per phase; the
  same corpus, push rows and parameter bytes; the flat scan's recall 1.0 in
  both and the int8 scans' recall against the exact scan above
  ``INT8_RECALL_FLOOR`` in both (a recall depends on each package's own
  weights, so values are held to a floor, not to each other).
- ``examples_torch/serving_bench.py``: its ``main`` host-observed and
  ``--device-side`` against the JAX script's ``main`` at the same flags.
  The JAX script runs on the CPU under its own ``RECOMMEND_TPU_BENCH_F32``
  (the CPU has no bf16 x bf16 dot); both scripts' ``get_config`` are
  narrowed to ``TINY_RANKING`` / ``TINY_RETRIEVAL`` (the full OneTrans-S
  tables take GBs), and the reports must carry the same keys, configs,
  counts and claims. The port's ``note`` keys (where it computes a
  quantity otherwise) are the only keys the JAX reports lack.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

import recommend_tpu.config as jconfig
from examples_torch import flagship_serving_bench, serving_bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CORPUS = 3000
INT8_RECALL_FLOOR = 0.97  # chip_smoke.py's gate on the flagship int8 rows
# ranking_base's tables cut to 1000 rows (the traffic draws ids below 100,
# items below 1000) and small widths; the retrieval tower of the JAX
# serving demo's --tiny
TINY_RANKING = dict(
    embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, num_ns_tokens=4,
    pyramid_ratios=(0.5, 0.25), feature_embed_dim=8, seq_item_feature_dim=8,
    use_mixed_precision=False,
    feature_vocab_sizes=tuple((f, min(v, 1000)) for f, v in
                              jconfig.get_config("ranking_base").feature_vocab_sizes),
)
TINY_RETRIEVAL = dict(embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, max_seq_len=16,
                      compression_schedule=((8, 4), (8, 1)), compute_dtype="float32")


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrowed(get_config):
    """``get_config`` with the tiny widths laid over the caller's own."""
    tiny = {"ranking_base": TINY_RANKING, "retrieval_base": TINY_RETRIEVAL}

    def get(name, **overrides):
        return get_config(name, **{**overrides, **tiny.get(name, {})})

    return get


def key_paths(d, prefix=()):
    """Every key path of a nested dict; a port ``note`` is left out."""
    out = set()
    for k, v in d.items():
        if k == "note":
            continue
        out.add(prefix + (str(k),))
        if isinstance(v, dict):
            out |= key_paths(v, prefix + (str(k),))
    return out


def test_flagship_serving_bench_reports_what_the_jax_phases_report(tmp_path, capsys):
    jax_mod = jax_script("flagship_serving_bench")
    jax_mod.phase_flat(CORPUS, str(tmp_path / "flat.json"))
    jax_mod.phase_ivf(CORPUS, str(tmp_path / "ivf.json"))
    jax_mod.phase_checkpoint(CORPUS, str(tmp_path / "checkpoint.json"))
    want = {p: json.loads((tmp_path / f"{p}.json").read_text())
            for p in ("flat", "ivf", "checkpoint")}
    out = tmp_path / "port.json"
    assert flagship_serving_bench.main(["--corpus", str(CORPUS), "--output", str(out),
                                        "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    printed = capsys.readouterr().out
    assert all(f'"{phase}": {{' in printed for phase in got), printed[-500:]
    assert set(got) == set(want)
    for phase, ref in want.items():
        assert key_paths(got[phase]) - {("device",)} == key_paths(ref), phase
        assert got[phase]["corpus"] == ref["corpus"] == CORPUS
    for name in ("flat_exact", "int8_exact", "int8_approx99"):
        for report in (got["flat"], want["flat"]):
            recall = report[name]["top100_recall_vs_exact"]
            assert recall == 1.0 if name == "flat_exact" else INT8_RECALL_FLOOR <= recall <= 1.0
    assert 0.0 <= got["ivf"]["top100_recall_vs_exact"] <= 1.0
    assert (got["ivf"]["clusters"], got["ivf"]["nprobe"]) == (want["ivf"]["clusters"],
                                                             want["ivf"]["nprobe"]) == (4096, 16)
    ck, ref = got["checkpoint"], want["checkpoint"]
    assert ck["push_rows"] == ref["push_rows"]  # the same draw of touched ids
    assert abs(ck["params_gb"] - ref["params_gb"]) < 0.01  # JAX rounds to 0.01
    assert abs(ck["push_mb"] - ref["push_mb"]) / ref["push_mb"] < 0.01
    # the asynchronous save: device steps ran between save() and wait()
    assert ck["overlapped_device_steps_during_write"] >= 5
    assert 0 < ck["orbax_save_return_s"] < ck["orbax_save_total_s"]
    assert "note" not in ck


@pytest.mark.parametrize("argv", [
    ["--requests", "4", "--candidates", "8", "--corpus", "2000"],
    ["--device-side", "--chains", "2", "--chain-len", "3", "--candidates", "8"],
], ids=["host", "device_side"])
def test_serving_bench_reports_what_the_jax_script_reports(monkeypatch, tmp_path, capsys, argv):
    monkeypatch.setenv("RECOMMEND_TPU_BENCH_F32", "1")
    monkeypatch.setattr(jconfig, "get_config", narrowed(jconfig.get_config))
    monkeypatch.setattr(serving_bench, "get_config", narrowed(serving_bench.get_config))
    jax_mod = jax_script("serving_bench")
    monkeypatch.setattr(sys, "argv", ["serving_bench.py", *argv, "--output",
                                      str(tmp_path / "jax.json")])
    jax_mod.main()
    jax_out = capsys.readouterr().out
    assert serving_bench.main([*argv, "--output", str(tmp_path / "port.json"),
                               "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert key_paths(got) == key_paths(want)
    assert got["reference_claims"] == want["reference_claims"]
    assert got["device"] == "cpu"
    for out in (jax_out, port_out):
        assert out.startswith("device=") and " rtt=" in out.splitlines()[0]
    if "--device-side" in argv:
        ds, ref = got["ranking_device_side"], want["ranking_device_side"]
        assert ds["config"] == ref["config"]
        for key in ("kv_cached_request_device", "session_delta_kv_append_device"):
            assert (ds[key]["chains"], ds[key]["chain_len"]) == (2, 3)
        for key in ("kv_cached_request_device_scanned",
                    "session_delta_kv_append_device_scanned"):
            assert (ds[key]["k_per_dispatch"], ds[key]["samples"]) == (
                ref[key]["k_per_dispatch"], ref[key]["samples"])
            assert "back to back" in ds[key]["note"]
        return
    rk, ref = got["ranking"], want["ranking"]
    assert rk["config"] == ref["config"]
    assert rk["session_delta_kv_append"]["delta_mix"] == [1, 2, 4, 8]
    for section in ("retrieval", "retrieval_throughput"):
        assert got[section]["config"] == want[section]["config"]
    assert "exact top k" in got["retrieval_throughput"]["int8_approx99_batch64"]["note"]
