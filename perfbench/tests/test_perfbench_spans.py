"""The span phase's reduction (``yardstick/spans.py``) on a hand-built
export of the recorder and a hand-built trace with ``user_annotation``
ranges, the readers of its metrics, and the phase itself on a cell cut to
the CPU's size."""

import pytest
import torch

from conftest import SMALL_TRAFFIC, small
from perfbench.yardstick import spans as S

READERS = ("step_host_ms.train", "host_syncs_per_step.train", "optimizer_host_ms.train",
           "optimizer_idle_ms.train", "forward_ms.train", "backward_ms.train",
           "activation_gib.train", "sparse_unique_share.train")
# what each reader can read without a card
HOST_READERS = ("step_host_ms.train", "optimizer_host_ms.train", "sparse_unique_share.train")


def _reader(name):
    from perfbench.run import reader

    return reader(name)


def _span(name, parent, step, h0, h1, d0=None, d1=None):
    s = {"name": name, "parent": parent, "step": step, "host_start_ns": h0, "host_end_ns": h1}
    if d0 is not None:
        s.update(device_start_ms=d0, device_end_ms=d1)
    return s


def _export(step, t):
    """One step at host time ``t`` ns: 10 ms of host, forward 4 ms and
    optimizer 3 ms of it; on the device forward 6 ms and optimizer 2 ms."""
    ms = 1_000_000
    return {"spans": [_span("train_step", None, step, t, t + 10 * ms, 0.0, 9.0),
                      _span("forward", 0, step, t + ms, t + 5 * ms, 0.5, 6.5),
                      _span("optimizer", 0, step, t + 6 * ms, t + 9 * ms, 6.5, 8.5)],
            "counts": [{"name": "host_syncs", "key": None, "step": step, "span": 0, "value": 1},
                       {"name": "sparse_lookups", "key": "a", "step": step, "span": 2,
                        "value": 100},
                       {"name": "sparse_lookups", "key": "b", "step": step, "span": 2,
                        "value": 60},
                       {"name": "sparse_unique_rows", "key": "a", "step": step, "span": 2,
                        "value": 30},
                       {"name": "sparse_unique_rows", "key": "b", "step": step, "span": 2,
                        "value": 10},
                       {"name": "activation_bytes", "key": None, "step": step, "span": 0,
                        "value": 2**30 * (step + 1)},
                       {"name": "stray", "key": None, "step": None, "span": None,
                        "value": 7}],
            "registered": {}}


def test_reduce_exports_gives_per_step_means():
    r = S.reduce_exports([_export(0, 0), _export(1, 10**8)])
    assert r["steps"] == 2
    assert r["host_ms"] == pytest.approx({"train_step": 10, "forward": 4, "optimizer": 3})
    assert r["self_ms"] == pytest.approx({"train_step": 3, "forward": 4, "optimizer": 3})
    assert r["device_ms"] == pytest.approx({"train_step": 9, "forward": 6, "optimizer": 2})
    assert r["counts"] == pytest.approx({"host_syncs": 1, "sparse_lookups": 160,
                                         "sparse_unique_rows": 40,
                                         "activation_bytes": 1.5 * 2**30})
    assert r["sums"]["sparse_lookups"] == 320 and "stray" not in r["sums"]
    assert S.reduce_exports([{"spans": [], "counts": []}]) == {"steps": 0}


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
            "args": args}


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid, correlation=corr)


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, pid=0, tid=7, correlation=corr)


@pytest.fixture
def span_trace():
    """One step on thread 1: forward [10, 100), backward [100, 200) whose
    kernels thread 2 (the autograd engine) launches, optimizer [200, 400);
    a kernel launched before the step, outside every span, ends the first
    gap. Kernels (ts, end): 5-15 (outside), 40-60 (forward), 150-170
    (backward, thread 2), 300-310 and 390-400 (optimizer), 420-430 (copy
    launched by the optimizer, no kernel name)."""
    return [
        _launch(1, 1), _kernel(5, 10, 1),
        _x("user_annotation", "train_step_4", 10, 400),
        _x("user_annotation", "forward", 10, 90),
        _x("user_annotation", "backward", 100, 100),
        _x("user_annotation", "optimizer", 200, 200),
        _launch(30, 2), _kernel(40, 20, 2),
        _launch(120, 3, tid=2), _kernel(150, 20, 3),
        _launch(250, 4), _kernel(300, 10, 4),
        _launch(380, 5), _kernel(390, 10, 5),
        _launch(395, 6), _x("gpu_memcpy", "Memcpy DtoD", 420, 10, pid=0, tid=7,
                            correlation=6),
        _x("gpu_user_annotation", "forward", 40, 20, pid=0, tid=7),
        _x("gpu_user_annotation", "train_step_4", 40, 390, pid=0, tid=7),
    ]


def test_idle_gaps_are_keyed_by_the_innermost_span_on_the_step_thread(span_trace):
    r = S.idle_by_span(span_trace)
    assert r["steps"] == 1 and r["device_events"] == 6
    # 15..40 ended by a forward kernel; 60..150 by a kernel the engine's
    # thread launched while the step's thread was in backward; 170..300 and
    # 310..390 in the optimizer, 400..420 too
    assert r["idle_ms"] == pytest.approx({"forward": 0.025, "backward": 0.090,
                                          "optimizer": 0.130 + 0.080 + 0.020})
    assert r["idle_total_ms"] == pytest.approx(0.345)
    assert r["annotation_ms"] == pytest.approx({"forward": 0.020, "train_step": 0.390})


def test_a_gap_ended_by_a_launch_outside_every_span_is_under_none(span_trace):
    # the first kernel launched again after the step: it now ends a gap
    ev = span_trace + [_launch(500, 9), _kernel(600, 10, 9)]
    r = S.idle_by_span(ev)
    assert r["idle_ms"][S.OUTSIDE] == pytest.approx(0.170)
    assert sum(r["idle_ms"].values()) == pytest.approx(r["idle_total_ms"])


def _ctx(readings):
    return {"profile": {"steps": 3}, "spans": readings}


def test_the_readers_on_hand_built_readings(span_trace):
    r = S.reduce_exports([_export(0, 0), _export(1, 10**8)])
    r["profiled"] = S.idle_by_span(span_trace)
    got = {n: _reader(n).read(_ctx(r)) for n in READERS}
    assert got.pop("backward_ms.train") is None  # no backward span in the export
    assert got == pytest.approx({
        "step_host_ms.train": 10.0, "host_syncs_per_step.train": 1.0,
        "optimizer_host_ms.train": 3.0, "optimizer_idle_ms.train": 0.23,
        "forward_ms.train": 6.0, "activation_gib.train": 1.5,
        "sparse_unique_share.train": 25.0})


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_untraced_or_without_the_recorder(name, monkeypatch):
    def never(*a, **k):
        raise AssertionError("the span phase ran")

    monkeypatch.setattr(S, "run_phase", never)
    assert _reader(name).read({"cfg": {}, "traffic": {}}) is None
    # a program without the recorder (the parent of this change) reads None
    assert _reader(name).read(_ctx(None)) is None


def test_a_program_without_the_recorder_runs_no_phase(monkeypatch):
    from recommend_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    assert S.run_phase({}, {}, 0, torch.device("cpu")) is None


def test_the_phase_on_the_cpu(cell):
    """The whole phase on a cell cut to the CPU: the host spans and the
    sparse counts are read; the card's readings (CUDA events, syncs,
    allocations, the device's idle) are not."""
    ctx = {"cfg": small(cell["config"]), "traffic": dict(SMALL_TRAFFIC), "profile": {},
           "seed": 2**31 + 7}
    assert _reader("step_host_ms.train").read(ctx) is None  # untraced: an empty profile
    ctx["profile"] = {"steps": 1}
    got = {n: _reader(n).read(ctx) for n in READERS}
    assert {n for n, v in got.items() if v is not None} == set(HOST_READERS), got
    r = ctx["spans"]
    assert r["steps"] == 2 * S.SPAN_STEPS and r["profiled"]["steps"] == S.SPAN_STEPS
    assert 0 < got["optimizer_host_ms.train"] < got["step_host_ms.train"]
    assert 0 < got["sparse_unique_share.train"] < 100
    assert [len(r["cost"][m]) for m in ("off", "on")] == [2, 2]


@pytest.mark.chip
def test_host_syncs_counts_the_syncs_inside_a_step_on_the_card():
    """On the card a step counts each synchronisation inside it, and none
    outside; every span has its device times; the sync mode is put back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommend_tpu_torch.utils import profiling

    x = torch.ones(4, device="cuda")
    with profiling.recording():
        with profiling.span("train_step", step=0):
            with profiling.span("forward"):
                y = x * 2
        with profiling.span("train_step", step=1):
            float(y.sum())
            y.nonzero()
        float(y.sum())
    rec = profiling.export()
    assert [(c["step"], c["value"]) for c in rec["counts"] if c["name"] == "host_syncs"] \
        == [(0, 0), (1, 2)]
    assert all("device_start_ms" in s for s in rec["spans"])
    assert torch.cuda.get_sync_debug_mode() == 0
