"""The port's profiling tools (``tools_torch/``) beside the JAX tools they
port (``tools/``), on the CPU:

- ``profile_bench``: its config for S and L, with and without the kernels,
  equals the JAX tool's field for field (the JAX tool's config is caught
  where it calls ``make_ranking_data``), and its flops a step are JAX's
  ``ranking_model_flops(cfg, 3·seq + 2, training=True) × batch``; its
  ``main`` times and traces a narrowed config on the CPU;
- ``analyze_profile`` on a hand-built Chrome trace: device time and busy
  time, the category, entry-point and source rollups, the roofline counts,
  a backward op's kernels attributed to its forward op's frame (through the
  ``fwdbwd`` flow, or the sequence number when the trace has no flow), and
  the ``--json`` dump; it raises on a real CPU trace of a port step;
- ``mfu_accounting``, given the totals the JAX tool is given, the same
  flops, device ms and slice ms, its MFUs in the ratio 197e12 / the H100's
  peak;
- ``aggregate_quality``: the JAX tool's board, byte for byte, on the TPU's
  and the port's seed runs.
"""

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import recommend_tpu.config as jconfig
import recommend_tpu.data.synthetic as jsynthetic
from recommend_tpu.evaluation.benchmark import ranking_model_flops as j_flops
from recommend_tpu_torch.data.pipeline import ranking_batches
from recommend_tpu_torch.data.synthetic import make_ranking_data
from recommend_tpu_torch.evaluation.benchmark import peak_flops
from recommend_tpu_torch.ops import flash_attention as fa
from tools_torch import aggregate_quality, analyze_profile, mfu_accounting, profile_bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


@pytest.mark.parametrize("geometry,seq,flash", [("S", 116, True), ("L", 396, True),
                                                ("S", 116, False), ("L", 396, False)])
def test_profile_bench_config_and_flops_equal_the_jax_tools(monkeypatch, geometry, seq, flash):
    def catch(cfg, **kwargs):
        raise _Caught(cfg, kwargs)

    monkeypatch.setattr(jsynthetic, "make_ranking_data", catch)
    argv = ["--geometry", geometry, "--batch", "512", "--seq", str(seq)]
    monkeypatch.setattr(sys, "argv", ["profile_bench.py", *argv,
                                      *([] if flash else ["--no-flash"])])
    with pytest.raises(_Caught) as caught:
        jax_tool("profile_bench").main()
    jcfg, data_kwargs = caught.value.args
    assert data_kwargs == {"num_samples": profile_bench.NUM_SAMPLES,
                           "max_seq_per_feature": seq, "seed": 0}
    args = profile_bench.parse_args(argv + ([] if flash else ["--no-flash"]))
    cfg = profile_bench.config(args.geometry, args.batch, not args.no_flash)
    assert cfg.to_dict() == jcfg.to_dict()
    # the S length of a batch: three sequences of --seq and two [SEP]s
    small = profile_bench.config(geometry, 4)
    first = next(ranking_batches(make_ranking_data(small, num_samples=8,
                                                   max_seq_per_feature=seq, seed=0),
                                 small, batch_size=4, seed=0))
    assert profile_bench.flops_per_step(cfg, first) == j_flops(
        jcfg, 3 * seq + 2, training=True) * 512


def _narrowed(get_config):
    tiny = dict(embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, num_ns_tokens=4,
                pyramid_ratios=(0.5, 0.25), feature_embed_dim=8, seq_item_feature_dim=8,
                feature_vocab_sizes=tuple(
                    (f, min(v, 1000)) for f, v in
                    jconfig.get_config("ranking_base").feature_vocab_sizes))

    def get(name, **overrides):
        return get_config(name, **{**overrides, **tiny})

    return get


def test_profile_bench_times_and_traces_a_narrowed_step_on_the_cpu(monkeypatch, tmp_path,
                                                                    capsys):
    monkeypatch.setattr(profile_bench, "get_config", _narrowed(profile_bench.get_config))
    base = ["--geometry", "L", "--batch", "4", "--seq", "8", "--device", "cpu"]
    timed = profile_bench.run(profile_bench.parse_args(base + ["--no-trace", "--steps", "2"]))
    assert math.isfinite(timed["loss"]) and timed["ms_per_step"] > 0
    assert timed["mfu_wall_pct"] is None and timed["peak_flops"] is None
    assert "train MFU not computed" in capsys.readouterr().out
    traced = profile_bench.run(profile_bench.parse_args(
        base + ["--steps", "1", "--out", str(tmp_path / "prof")]))
    assert Path(traced["trace"]).is_file() and math.isfinite(traced["loss"])
    trace = json.loads(Path(traced["trace"]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train_step_0" in names
    assert any(e.get("cat") == "python_function" for e in trace["traceEvents"])
    # a CPU trace holds no device kernel: the analysis refuses it
    with pytest.raises(SystemExit, match="no device kernels"):
        analyze_profile.main([str(tmp_path / "prof"), "--device", "cpu"])


# -- a hand-built trace -------------------------------------------------------
PID, MAIN, AUTOGRAD = 1, 10, 20
FA = "recommend_tpu_torch/ops/flash_attention.py"
SE = "recommend_tpu_torch/ops/sparse_embed.py"
KERNELS = {  # correlation -> (name, duration, stream)
    1: ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float>", 10.0, 7),
    2: ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_cublas", 40.0, 7),
    3: ("void sm90::band_attn_fwd_sm90_kernel<128, false>(sm90::Params)", 30.0, 7),
    8: ("void sm90::band_attn_fwd_sm90_kernel<128, true>(sm90::Params)", 20.0, 8),
    4: ("void at::native::embedding_backward_feature_kernel<float>", 15.0, 7),
    5: ("void sm90::band_attn_bwd_dq_sm90_kernel<128>(sm90::BwdParams)", 10.0, 7),
    6: ("void sm90::band_attn_bwd_dkv_sm90_kernel<128>(sm90::BwdParams)", 35.0, 7),
    7: ("void sm90::band_attn_bwd_dq_sm90_kernel<128>(sm90::BwdParams)", 10.0, 7),
    11: ("void sm90::band_attn_bwd_dkv_sm90_kernel<128>(sm90::BwdParams)", 14.0, 7),
    9: ("void at::native::indexFuncLargeIndex<float>", 8.0, 7),
    10: ("Memcpy DtoH (Device -> Pinned)", 5.0, 7),
    12: ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>",
         6.0, 8),
}
# correlation -> (launch thread, launch time); 12 has no launch in the trace
# (launched before the window) and runs at time 330 on stream 8, inside
# kernel 3's span on stream 7
LAUNCH = {1: (MAIN, 30), 2: (MAIN, 120), 3: (MAIN, 320), 8: (MAIN, 415), 4: (AUTOGRAD, 520),
          5: (AUTOGRAD, 710), 6: (AUTOGRAD, 720), 7: (AUTOGRAD, 810), 11: (AUTOGRAD, 820),
          9: (MAIN, 960), 10: (MAIN, 980)}
MM_FLOPS = 2 * 4 * 8 * 16
MM_BYTES = (4 * 8 + 8 * 16) * 4
# correlation -> the source each kernel is attributed to
SOURCES = {1: "ops/sparse_embed.py:lookup_with_dummy", 2: "models/ranking.py:_ffn_s",
           3: "ops/flash_attention.py:_launch", 8: "ops/flash_attention.py:_launch",
           4: "ops/sparse_embed.py:lookup_with_dummy",
           5: "ops/flash_attention.py:band_attn_blocked_fwd",
           6: "ops/flash_attention.py:band_attn_blocked_fwd",
           7: "ops/flash_attention.py:band_attn_segkv_fwd",
           11: "ops/flash_attention.py:band_attn_segkv_fwd",
           9: "ops/sparse_embed.py:sparse_rowwise_update_table",
           10: "training/ranking_trainer.py:_train_step", 12: "?"}
ENTRY = {3: "band_attn_blocked_fwd", 8: "band_attn_segkv_fwd", 5: "band_attn_blocked_bwd_dq",
         6: "band_attn_blocked_bwd_dkv", 7: "band_attn_segkv_bwd", 11: "band_attn_segkv_bwd"}


def _x(cat, name, tid, ts, dur, pid=PID, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _step(t, corr_base, flows):
    """One step's host and device events, shifted by ``t`` µs."""
    f = lambda tid, name, s, e: _x("python_function", name, tid, t + s, e - s)  # noqa: E731
    op = lambda tid, name, s, e, **a: _x("cpu_op", name, tid, t + s, e - s, **a)  # noqa: E731
    ev = [
        _x("user_annotation", f"train_step_{corr_base // 100}", MAIN, t, 1000),
        f(MAIN, "recommend_tpu_torch/training/ranking_trainer.py(280): _train_step", 5, 995),
        f(MAIN, f"{SE}(50): lookup_with_dummy", 20, 100),
        f(MAIN, "recommend_tpu_torch/models/ranking.py(170): _ffn_s", 100, 300),
        f(MAIN, "torch/nn/functional.py(2000): linear", 105, 295),
        f(MAIN, f"{FA}(343): band_attn_blocked_fwd", 300, 400),
        f(MAIN, f"{FA}(299): _launch", 310, 390),
        f(MAIN, f"{FA}(479): band_attn_segkv_fwd", 405, 450),
        f(MAIN, f"{FA}(299): _launch", 410, 445),
        f(MAIN, f"{SE}(300): sparse_rowwise_update_table", 950, 975),
        # the custom backward's Python frames on the engine's thread
        f(AUTOGRAD, f"{FA}(608): backward", 800, 900),
        f(AUTOGRAD, f"{FA}(500): band_attn_segkv_bwd", 805, 895),
        op(MAIN, "aten::embedding", 25, 90, **{
            "Sequence number": 5, "Fwd thread id": 0,
            "Input Dims": [[1000, 8], [4, 3]], "Input type": ["float", "long int"]}),
        op(MAIN, "aten::linear", 110, 210, **{"Sequence number": 6, "Fwd thread id": 0}),
        op(MAIN, "aten::mm", 115, 200, **{
            "Sequence number": 6, "Fwd thread id": 0,
            "Input Dims": [[4, 8], [8, 16]], "Input type": ["float", "float"]}),
        op(MAIN, "_BlockedAttention", 305, 395, **{"Sequence number": 9, "Fwd thread id": 0}),
        op(MAIN, "_SegmentedAttention", 408, 448,
           **{"Sequence number": 11, "Fwd thread id": 0}),
        op(AUTOGRAD, "autograd::engine::evaluate_function: EmbeddingBackward0", 500, 600,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        op(AUTOGRAD, "EmbeddingBackward0", 505, 595,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        op(AUTOGRAD, "aten::embedding_dense_backward", 510, 590),
        op(AUTOGRAD, "_BlockedAttentionBackward", 700, 790,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        op(AUTOGRAD, "_SegmentedAttentionBackward", 798, 902,
           **{"Sequence number": 11, "Fwd thread id": 1}),
    ]
    if flows:
        for fid, (fwd_ts, bwd_ts) in enumerate(((25, 505), (305, 700), (408, 798))):
            fid = corr_base + fid
            ev.append({"ph": "s", "id": fid, "pid": PID, "tid": MAIN, "ts": t + fwd_ts,
                       "cat": "fwdbwd", "name": "fwdbwd"})
            ev.append({"ph": "f", "id": fid, "pid": PID, "tid": AUTOGRAD, "ts": t + bwd_ts,
                       "cat": "fwdbwd", "name": "fwdbwd", "bp": "e"})
    for corr, (tid, ts) in LAUNCH.items():
        name = "cudaMemcpyAsync" if corr == 10 else "cudaLaunchKernel"
        ev.append(_x("cuda_runtime", name, tid, t + ts, 3, correlation=corr_base + corr))
    for corr, (name, dur, stream) in KERNELS.items():
        ts = LAUNCH[corr][1] + 5 if corr in LAUNCH else 330
        ev.append(_x("gpu_memcpy" if corr == 10 else "kernel", name, stream, t + ts, dur,
                     pid=0, correlation=corr_base + corr, stream=stream, device=0))
    return ev


def hand_trace(path, flows=True):
    trace = {"schemaVersion": 1, "deviceProperties": [{"id": 0, "name": H100}],
             "traceEvents": _step(0.0, 0, flows) + _step(1000.0, 100, flows)}
    path.write_text(json.dumps(trace))
    return path


@pytest.mark.parametrize("flows", [True, False], ids=["fwdbwd_flow", "sequence_number"])
def test_analyze_profile_on_a_hand_built_trace(tmp_path, capsys, flows):
    trace = hand_trace(tmp_path / "trace.json", flows)
    dump = tmp_path / "prof.json"
    s = analyze_profile.run(analyze_profile.parse_args(
        [str(tmp_path), "--json", str(dump), "--wall-ms", "2.5", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert s["steps"] == 2 and s["device"] == H100 and s["trace"] == str(trace)
    durs = {c: KERNELS[c][1] for c in KERNELS}
    assert s["device_us"] == pytest.approx(2 * sum(durs.values()))
    # kernel 12 (stream 8) runs inside kernel 3's span on stream 7: the union
    # is the sum less its duration
    assert s["busy_us"] == pytest.approx(2 * (sum(durs.values()) - durs[12]))
    assert s["busy_us"] < s["device_us"]
    cats = {k: v["us"] / 2 for k, v in s["categories"].items()}
    assert cats == pytest.approx({
        "index/scatter": durs[1] + durs[4] + durs[9], "gemm": durs[2], "copy": durs[10],
        "band attention": durs[3] + durs[8] + durs[5] + durs[6] + durs[7] + durs[11],
        "elementwise": durs[12]})
    want_entries = {}
    for corr, entry in ENTRY.items():
        want_entries[entry] = want_entries.get(entry, 0.0) + durs[corr]
    assert {k: v["us"] / 2 for k, v in s["band_attention"].items()} == pytest.approx(
        want_entries)
    assert s["band_attention"]["band_attn_segkv_bwd"]["count"] == 4
    want_sources = {}
    for corr, src in SOURCES.items():
        want_sources[src] = want_sources.get(src, 0.0) + durs[corr]
    assert {k: v / 2 for k, v in s["sources"].items()} == pytest.approx(want_sources)
    assert s["attributed"] == {"frame": 12, "forward frame": 10, "none": 2}
    gemm = next(r for r in s["rows"] if r["category"] == "gemm")
    assert (gemm["flops"], gemm["bytes"]) == (2 * MM_FLOPS, 2 * MM_BYTES)
    assert gemm["gflop_per_s"] == pytest.approx(2 * MM_FLOPS / 1e9 / (2 * durs[2] / 1e6))
    assert gemm["bound_by"] == "bytes"  # 640 B at 3.35 TB/s outlast 1,024 flops
    embed = next(r for r in s["rows"] if r["name"] == KERNELS[1][0])
    assert embed["bytes"] == 2 * (1000 * 8 * 4 + 4 * 3 * 8) and embed["flops"] is None
    # the printed sections, in the JAX tool's order
    for text in ("device time:", "busy (union)", "category", "band_attn_segkv_bwd",
                 "cum%", "source (innermost recommend_tpu_torch frame)"):
        assert text in out, text
    assert out.index("category") < out.index("cum%") < out.index("source (innermost")
    # each backward node the fallback names is an autograd Function's
    for node, entries in analyze_profile.BACKWARD_NODES.items():
        assert hasattr(fa, node[:-len("Backward")]) and set(entries) <= set(fa.LAUNCHES)
    written = json.loads(dump.read_text())
    assert written["steps"] == 2 and written["device"] == H100
    assert written["wall_ms_per_step"] == 2.5
    assert {r["source"] for r in written["rows"]} == set(SOURCES.values())


def test_mfu_accounting_reads_the_dump_of_analyze_profile(tmp_path, capsys):
    hand_trace(tmp_path / "trace.json")
    dump = tmp_path / "prof.json"
    analyze_profile.main([str(tmp_path / "trace.json"), "--json", str(dump), "--wall-ms",
                          "2.5", "--device", "cpu"])
    out = mfu_accounting.run(mfu_accounting.parse_args(
        [str(dump), "--geometry", "S", "--seq", "116", "--device", "cpu"]))
    durs = sum(k[1] for k in KERNELS.values())
    embed = KERNELS[1][1] + KERNELS[4][1] + KERNELS[9][1]
    assert out["device_ms_per_step"] == pytest.approx(durs / 1e3)
    assert out["embedding_slice_ms_per_step"] == pytest.approx(embed / 1e3)
    assert out["mfu_wall_pct"] == pytest.approx(
        out["train_flops_per_step"] / 2.5e-3 / peak_flops(H100) * 100)
    assert "ps_view_error" not in out


@pytest.mark.parametrize("geometry,seq", [("L", 396), ("S", 116)])
def test_mfu_accounting_matches_the_jax_tool_on_the_same_totals(monkeypatch, tmp_path, capsys,
                                                                geometry, seq):
    # per step over 4 steps: 123.45 ms of device time, 23.45 ms of it in
    # ops/sparse_embed.py
    rows_us = [("ops/sparse_embed.py", 60_000.0), ("ops/sparse_embed.py", 33_800.0),
               ("models/ranking.py", 300_000.0), ("training/optimizer.py", 100_000.0)]
    jax_dump = {"steps": 4, "rows": [
        {"total_self_time": us, "source_info":
            f"<a title='/repo/recommend_tpu/{src}:12\n/repo/bench.py:1'>x</a>"}
        for src, us in rows_us]}
    port_dump = {"steps": 4, "device": H100, "rows": [
        {"total_us": us, "source": f"{src}:fn"} for src, us in rows_us]}
    (tmp_path / "jax.json").write_text(json.dumps(jax_dump))
    (tmp_path / "port.json").write_text(json.dumps(port_dump))
    flags = ["--geometry", geometry, "--batch", "512", "--seq", str(seq)]
    monkeypatch.setattr(sys, "argv", ["mfu_accounting.py", str(tmp_path / "jax.json"), *flags])
    jax_tool("mfu_accounting").main()
    want = json.loads(capsys.readouterr().out)
    got = mfu_accounting.run(mfu_accounting.parse_args(
        [str(tmp_path / "port.json"), *flags, "--device", "cpu"]))
    assert got["train_flops_per_step"] == want["train_flops_per_step"]
    assert got["s_tokens"] == want["s_tokens"] == 3 * seq + 2
    assert round(got["device_ms_per_step"], 2) == want["device_ms_per_step"] == 123.45
    assert round(got["embedding_slice_ms_per_step"], 2) == \
        want["embedding_slice_ms_per_step"] == 23.45
    ratio = 197e12 / peak_flops(H100)
    # the JAX tool rounds its MFUs to 0.1
    assert got["mfu_inline_pct"] == pytest.approx(want["mfu_inline_pct"] * ratio,
                                                  abs=0.05 * ratio)
    assert got["mfu_parameter_server_view_pct"] == pytest.approx(
        want["mfu_parameter_server_view_pct"] * ratio, abs=0.05 * ratio)
    assert "mfu_wall_pct" not in got and "ps_view_error" not in got


def test_mfu_accounting_keeps_the_ps_view_guard(tmp_path, capsys):
    dump = {"steps": 1, "device": H100, "rows": [
        {"total_us": 1000.0, "source": "ops/sparse_embed.py:lookup_with_dummy"}]}
    (tmp_path / "p.json").write_text(json.dumps(dump))
    got = mfu_accounting.run(mfu_accounting.parse_args([str(tmp_path / "p.json"),
                                                        "--device", "cpu"]))
    assert "ps_view_error" in got and math.isfinite(got["mfu_parameter_server_view_pct"])


@pytest.mark.parametrize("inputs", [
    [f"quality_r05_seed{s}.json" for s in range(3)],
    [f"quality_torch_onetrans_S_seed{s}.json" for s in range(5)],
], ids=["tpu_r05", "port_onetrans_S"])
def test_aggregate_quality_writes_the_jax_tools_board(monkeypatch, tmp_path, capsys, inputs):
    paths = [str(ROOT / p) for p in inputs]
    monkeypatch.setattr(sys, "argv", ["aggregate_quality.py", *paths, "--output",
                                      str(tmp_path / "jax.json")])
    jax_tool("aggregate_quality").main()
    board = aggregate_quality.run(aggregate_quality.parse_args(
        [*paths, "--output", str(tmp_path / "port.json"), "--device", "cpu"]))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    # the board returned is the board written (JSON keys are strings)
    assert json.loads(json.dumps(board)) == json.loads((tmp_path / "jax.json").read_text())
    assert board["onetrans"]["final"]["ctr_auc"]["n_seeds"] == len(inputs)
    assert np.isfinite(board["onetrans"]["final"]["ctr_auc"]["mean"])


def test_phase_t_launch_rule_matches_the_dispatch_of_an_l_step(monkeypatch):
    """chip_smoke's phase T gates its launches with ``t_launches_per_step``
    (the dispatch rule read from the pyramid); one CPU training step at
    OneTrans-L's widths and S = 1,190 (float32, tables cut to 1,000 rows,
    batch 2) calls each band-attention wrapper as often: B2f/B2dq/B2dkv at
    layer 0, B1f/B1b at layers 1-3."""
    import chip_smoke
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    calls = dict.fromkeys(fa.LAUNCHES, 0)

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in fa.LAUNCHES:
        monkeypatch.setattr(fa, name, counting(name, getattr(fa, name)))
    full = profile_bench.config("L", 2)
    cfg = dataclasses.replace(full, use_mixed_precision=False, feature_vocab_sizes=tuple(
        (f, min(v, 1000)) for f, v in full.feature_vocab_sizes))
    seq = 396
    data = make_ranking_data(cfg, num_samples=4, max_seq_per_feature=seq, seed=0)
    batch = next(ranking_batches(data, cfg, batch_size=2, seed=0))
    trainer = RankingTrainer(cfg, device="cpu")
    state = trainer.init_state(seed=0)
    _, metrics = trainer._train_step(state, trainer._put_batch(batch))
    assert math.isfinite(float(metrics["loss"]))
    want = chip_smoke.t_launches_per_step(profile_bench.config("L", 512), seq, 512)
    assert want == {"band_attn_blocked_fwd": 1, "band_attn_blocked_bwd_dq": 1,
                    "band_attn_blocked_bwd_dkv": 1, "band_attn_segkv_fwd": 3,
                    "band_attn_segkv_bwd": 3}
    assert {k: v for k, v in calls.items() if v} == want
    blocked, segmented = chip_smoke.l_kernel_shapes(profile_bench.config("L", 512), seq, 512)
    assert blocked == [dict(b=1536, h=1, lq=601, ls=1202, n=0, dh=128)]
    assert [(s["lq"], s["ls"], s["n"]) for s in segmented] == [(361, 589, 12), (240, 349, 12),
                                                              (120, 228, 12)]


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm"])
def test_product_flops_from_shapes_equal_with_flops_count(op):
    """The Chrome trace leaves ``with_flops``' count out; the analysis
    applies its formulas to the recorded shapes and must get its count."""
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    calls = {"mm": lambda: torch.mm(a[0], b[0]),
             "addmm": lambda: torch.addmm(torch.randn(5, 2), a[0], b[0]),
             "bmm": lambda: torch.bmm(a, b),
             "baddbmm": lambda: torch.baddbmm(torch.randn(3, 5, 2), a, b)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True, with_flops=True) as prof:
        calls[op]()
    ev = next(e for e in prof.events() if e.name == f"aten::{op}")
    assert ev.flops > 0
    assert analyze_profile._product_flops(ev.name, {"Input Dims": ev.input_shapes}) == ev.flops
    assert analyze_profile._product_flops(ev.name, {"Input Dims": ev.input_shapes[:1]}) is None
    assert analyze_profile._product_flops("aten::add", {"Input Dims": [[5], [5]]}) is None
