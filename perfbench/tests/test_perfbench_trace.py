"""The trace reduction on a small hand-made Chrome trace: attribution of a
forward kernel to its frame, of a backward kernel through the ``fwdbwd``
flow, busy and idle time, and the idle gaps by what the host was doing."""

import json

import pytest

from perfbench.yardstick import trace as T

NORM = "/x/recommend_tpu_torch/ops/normalization.py(22): forward"
OPT = "/x/recommend_tpu_torch/training/optimizer.py(140): step"
MAIN, BWD = (1, 1), (1, 2)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


@pytest.fixture
def trace_file(tmp_path):
    ev = [
        # forward: a norm kernel launched inside normalization.py
        _x("python_function", NORM, 0, 50),
        _x("cpu_op", "aten::mul", 10, 20, **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 5, correlation=1),
        _x("kernel", "elementwise_kernel", 20, 10, correlation=1),
        # backward of that op on the engine's thread, no Python frame there
        _x("cpu_op", "MulBackward0", 100, 20, tid=2, **{"Sequence number": 7,
                                                        "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 5, tid=2, correlation=2),
        _x("kernel", "elementwise_kernel_bwd", 130, 20, correlation=2),
        {"ph": "s", "cat": "fwdbwd", "id": 9, "pid": 1, "tid": 1, "ts": 10},
        {"ph": "f", "cat": "fwdbwd", "id": 9, "pid": 1, "tid": 2, "ts": 100},
        # the optimizer: a long host stretch, then a copy
        _x("python_function", OPT, 160, 100),
        _x("cpu_op", "aten::copy_", 240, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 242, 3, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoD", 250, 10, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_attribution(trace_file):
    rows = T.load_events(trace_file)["events"]
    assert [r["source"] for r in rows] == ["ops/normalization.py:forward",
                                           "ops/normalization.py:forward",
                                           "training/optimizer.py:step"]
    assert T.by_source(rows, 2) == pytest.approx({"ops/normalization.py:forward": 15e-6,
                                                  "training/optimizer.py:step": 5e-6})


def test_busy_window_and_gaps(trace_file):
    loaded = T.load_events(trace_file)
    bw = T.busy_and_window(loaded["events"])
    assert bw["busy_s"] == pytest.approx(40e-6) and bw["window_s"] == pytest.approx(240e-6)
    # 30..130 waits on the backward thread's aten op, 150..250 on the optimizer
    gaps = dict((k, v) for k, v in T.top(loaded["idle"], 1))
    assert gaps == pytest.approx({"MulBackward0": 100e-6,
                                  "training/optimizer.py:step": 100e-6})


def _reader(name):
    from perfbench.run import reader

    return reader(name)


def test_band_attention_counts_every_route():
    """The band attention's time holds both routes, the kernels' dispatch
    and the plain path, and the model's time neither."""
    ctx = {"sources": {"ops/flash_attention.py:forward": 2e-3,
                       "ops/attention.py:dot_product_attention": 1e-3,
                       "ops/attention.py:causal_band_mask": 0.5e-3,
                       "models/ranking.py:_attend": 4e-3,
                       "ops/normalization.py:forward": 8e-3}}
    assert _reader("band_attn_ms.train").read(ctx) == pytest.approx(3.5)
    assert _reader("model_ms.train").read(ctx) == pytest.approx(4.0)
    assert _reader("rmsnorm_ms.train").read(ctx) == pytest.approx(8.0)
    assert _reader("band_attn_ms.train").read({"sources": {"models/ranking.py:x": 1.0}}) is None
