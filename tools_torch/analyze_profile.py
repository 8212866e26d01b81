"""Decompose device step time from a ``torch.profiler`` Chrome trace: the
port's counterpart of ``tools/analyze_profile.py``.

Reads a trace written by ``torch.profiler`` (``profile_bench.py``'s, or
``train(profile_dir=...)``'s ``trace_<a>-<b>.json``): a file, or the newest
``*.json`` under a directory. Prints, in the JAX tool's order:

- device time per step: the sum of kernel, memcpy and memset durations, and
  beside it their union (busy; streams that overlap make the two differ);
- a rollup by category, from kernel names: gemm, band attention (the
  ``csrc/`` kernels, also split by the port's nine entry points), elementwise,
  reduction, index/scatter, copy, other;
- the top ops (kernel name and source), with share, cumulative share and
  count per step, and roofline columns;
- a rollup by source: the innermost frame inside ``recommend_tpu_torch/``.

A device event is followed to its Python frame through its ``correlation``
id to the runtime launch event with the same id, then to the innermost
``python_function`` enclosing that launch on the launch's thread. A kernel
of an autograd backward op has no Python frame (it runs on the engine's
thread); it takes the frame of its forward op, found through the trace's
``fwdbwd`` flow, or failing that the ``Sequence number`` / ``Fwd thread id``
args, as XLA's source info points a backward op at its forward line.

The roofline columns are estimates, since the trace counts neither bytes
nor flops: flops are those ``with_flops`` counts for the enclosing aten
product (mm, addmm, bmm, baddbmm: its formulas on the recorded input
shapes, as the Chrome trace leaves the count out), bytes a lower bound from
the op's recorded input shapes and dtypes (outputs not counted), each op's
counts given to the longest device event it launched; ``bound`` is the
larger of bytes / 3.35 TB/s and flops / the card's dense bf16 peak
(``evaluation.benchmark.peak_flops``), ``?`` where the trace gives
neither.

Usage:
    python tools_torch/analyze_profile.py build/prof_L [--steps N] [--top 30]
        [--json out.json] [--contains substr] [--wall-ms MS]

``--steps`` divides totals by N (by default the number of ``train_step_<i>``
ranges in the trace, else 1). ``--wall-ms`` records an untraced wall time a
step in the ``--json`` dump, for ``mfu_accounting.py``'s wall-clock MFU. It
runs on the card's trace wherever it is given ``--device cpu``; without CUDA
and without ``--device`` it raises, like every entry point of the port.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import json
import math
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.evaluation.benchmark import peak_flops
from recommend_tpu_torch.ops.flash_attention import LAUNCHES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
# the nine CUDA entry points of ops/flash_attention.py (csrc/ kernels)
BAND_ATTENTION_ENTRY_POINTS = tuple(LAUNCHES)
# the backward node of each band-attention autograd Function, and the entry
# point(s) its backward launches (the blocked one's two passes: dq, dkv)
BACKWARD_NODES = {
    "_BlockedAttentionBackward": ("band_attn_blocked_bwd_dq", "band_attn_blocked_bwd_dkv"),
    "_WholeTileAttentionBackward": ("band_attn_bh_bwd",),
    "_ModelLayoutAttentionBackward": ("band_attn_mh_bwd",),
    "_SegmentedAttentionBackward": ("band_attn_segkv_bwd",),
}
# kernel name -> category, first match wins
CATEGORIES = (
    ("band attention", re.compile(r"band_attn")),
    ("copy", re.compile(r"copy|memcpy|memset", re.I)),
    ("gemm", re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitK", re.I)),
    ("index/scatter", re.compile(r"index|scatter|gather|embedding|segment|radix|sort|unique|"
                                 r"nonzero|cumsum", re.I)),
    ("reduction", re.compile(r"reduce|_norm|norm_|softmax|argmax|argmin|cub::", re.I)),
    ("elementwise", re.compile(r"elementwise|foreach|multi_tensor|functor|vectorized|"
                               r"unrolled|pointwise|fill", re.I)),
)
DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "long int": 8,
               "int": 4, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
               "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1}
_FRAME = re.compile(r"(?:^|/)recommend_tpu_torch/(\S+?\.py)\((\d+)\): (.*)$")
_ANY_FRAME = re.compile(r"^(\S+?\.py)\((\d+)\): (.*)$")
_STEP = re.compile(r"^train_step_(\d+)$")


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True),
                  key=os.path.getmtime)
    if not hits:
        raise SystemExit(f"no *.json trace under {path}")
    return hits[-1]


def category(name: str, cat: str) -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    for label, pattern in CATEGORIES:
        if pattern.search(name):
            return label
    return "other"


def repo_frame(frames) -> str:
    """``file:function`` of the innermost frame inside recommend_tpu_torch/
    (``frames`` outermost first), else the innermost frame's file, else ?."""
    for f in reversed(frames):
        m = _FRAME.search(f)
        if m:
            return f"{m.group(1)}:{m.group(3)}"
    if frames:
        m = _ANY_FRAME.match(frames[-1])
        return m.group(1) if m else frames[-1]
    return "?"


def entry_point(frames) -> str | None:
    """The band-attention entry point among ``frames``, if one is."""
    for f in reversed(frames):
        m = _FRAME.search(f)
        if m and m.group(1) == "ops/flash_attention.py" \
                and m.group(3) in BAND_ATTENTION_ENTRY_POINTS:
            return m.group(3)
    return None


def _stacks(intervals, times):
    """For each query time, the payloads of the intervals enclosing it,
    outermost first. ``intervals`` are (start, end, payload) of one thread,
    properly nested (a call stack)."""
    ivs = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out = [()] * len(times)
    stack = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(p for _, _, p in stack)
    return out


# aten product -> (rank of its operands, index of the first operand)
_PRODUCTS = {"aten::mm": (2, 0), "aten::addmm": (2, 1), "aten::bmm": (3, 0),
             "aten::baddbmm": (3, 1)}


def _product_flops(name: str, args: dict):
    """The flops ``with_flops`` counts for an aten product (its formulas,
    applied to the recorded input shapes: the Chrome trace leaves the count
    out), or None for any other op or shapes not recorded."""
    if name not in _PRODUCTS:
        return None
    rank, i = _PRODUCTS[name]
    dims = args.get("Input Dims") or []
    a, b = (dims[i:i + 2] + [None, None])[:2]
    if not (isinstance(a, list) and isinstance(b, list) and len(a) == len(b) == rank):
        return None
    return 2 * math.prod(a) * b[-1]


def _input_bytes(args: dict):
    dims, types = args.get("Input Dims"), args.get("Input type")
    if not dims or not types:
        return None
    total = 0
    for d, t in zip(dims, types):
        size = DTYPE_BYTES.get(t)
        if size is not None and isinstance(d, list):
            total += size * math.prod(d)
    return total


def load(trace_path: str) -> dict:
    """The trace's device events, each with its category, source frame,
    band-attention entry point and roofline counts."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    devices = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launches = {}
    frames = collections.defaultdict(list)
    ops = collections.defaultdict(list)
    flow_end, flow_start = {}, {}
    fwd_ops = collections.defaultdict(list)  # sequence number -> forward ops
    steps = set()
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph == "X" and cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif ph == "X" and cat == "python_function":
            frames[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif ph == "X" and cat == "cpu_op":
            ops[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e))
            a = e.get("args", {})
            if "Sequence number" in a and not a.get("Fwd thread id"):
                fwd_ops[a["Sequence number"]].append((e["ts"], e["pid"], e["tid"]))
        elif cat == "fwdbwd" and ph == "f":
            flow_end[(e["pid"], e["tid"], e["ts"])] = e["id"]
        elif cat == "fwdbwd" and ph == "s":
            flow_start[e["id"]] = (e["pid"], e["tid"], e["ts"])
        elif ph == "X" and cat == "user_annotation" and _STEP.match(e.get("name", "")):
            steps.add((e["name"], e["ts"], e["ts"] + e.get("dur", 0)))
    for v in fwd_ops.values():
        v.sort()

    # the launch of each device event, and the aten op around each launch
    launch_of = [launches.get(d.get("args", {}).get("correlation")) for d in devices]
    by_thread = collections.defaultdict(list)
    for i, ev in enumerate(launch_of):
        if ev is not None:
            by_thread[(ev["pid"], ev["tid"])].append(i)
    op_stack = [()] * len(devices)
    for key, idx in by_thread.items():
        for i, st in zip(idx, _stacks(ops[key], [launch_of[i]["ts"] for i in idx])):
            op_stack[i] = st

    # a backward op's forward point: its fwdbwd flow, else its sequence number
    def forward_point(op_events):
        for op in reversed(op_events):
            a = op.get("args", {})
            fid = flow_end.get((op["pid"], op["tid"], op["ts"]))
            if fid is not None and fid in flow_start:
                return op["name"], flow_start[fid]
            if a.get("Fwd thread id") and "Sequence number" in a:
                cands = fwd_ops.get(a["Sequence number"], [])
                k = bisect.bisect_left(cands, (op["ts"],)) - 1
                if k >= 0:
                    ts, pid, tid = cands[k]
                    return op["name"], (pid, tid, ts)
        return None, None

    queries = collections.defaultdict(list)  # thread -> [(time, device index, kind)]
    node_of = [None] * len(devices)
    for i, ev in enumerate(launch_of):
        if ev is None:
            continue
        queries[(ev["pid"], ev["tid"])].append((ev["ts"], i, "launch"))
        node, point = forward_point(op_stack[i])
        if point is not None:
            node_of[i] = node
            queries[(point[0], point[1])].append((point[2], i, "forward"))
    stacks = {"launch": [()] * len(devices), "forward": [()] * len(devices)}
    for key, qs in queries.items():
        for (_, i, kind), st in zip(qs, _stacks(frames[key], [q[0] for q in qs])):
            stacks[kind][i] = st

    # each op's counts go to the longest of the device events it launched
    longest = {}
    for i, st in enumerate(op_stack):
        if st and (id(st[-1]) not in longest
                   or devices[i].get("dur", 0) > devices[longest[id(st[-1])]].get("dur", 0)):
            longest[id(st[-1])] = i
    counted = set(longest.values())
    rows = []
    attributed = collections.Counter()
    for i, d in enumerate(devices):
        launch_frames, fwd_frames = stacks["launch"][i], stacks["forward"][i]
        # a backward op's kernels take its forward op's frame, as XLA's
        # source info points them at the forward line
        if any(_FRAME.search(f) for f in fwd_frames):
            source, how = repo_frame(fwd_frames), "forward frame"
        elif any(_FRAME.search(f) for f in launch_frames):
            source, how = repo_frame(launch_frames), "frame"
        else:
            source, how = repo_frame(launch_frames or fwd_frames), "none"
        attributed[how] += 1
        cat = category(d["name"], d.get("cat"))
        entry = None
        if cat == "band attention":
            entry = entry_point(launch_frames)
            if entry is None and node_of[i] in BACKWARD_NODES:
                choices = BACKWARD_NODES[node_of[i]]
                entry = choices[-1] if len(choices) > 1 and "dkv" in d["name"] else choices[0]
        flops = nbytes = None
        if i in counted:
            op = op_stack[i][-1]
            a = op.get("args", {})
            flops = a.get("flops", _product_flops(op["name"], a))
            nbytes = _input_bytes(a)
        rows.append({"name": d["name"], "cat": d.get("cat"), "category": cat,
                     "source": source, "entry_point": entry, "ts": d["ts"],
                     "dur": d.get("dur", 0), "stream": d.get("args", {}).get("stream"),
                     "flops": flops, "bytes": nbytes})
    props = trace.get("deviceProperties") or []
    step_ranges = sorted(steps, key=lambda s: s[1])
    return {"trace": trace_path, "device": props[0].get("name") if props else None,
            "events": rows, "attributed": dict(attributed),
            "step_ranges": [(s[1], s[2]) for s in step_ranges]}


def _union_us(events) -> float:
    total, end = 0.0, -math.inf
    for ev in sorted(events, key=lambda e: e["ts"]):
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(loaded: dict, steps, wall_ms=None) -> dict:
    """The per-step totals and the rows (kernel name x source) of a loaded
    trace."""
    events = loaded["events"]
    if not events:
        raise SystemExit(f"no device kernels in {loaded['trace']} — was the trace taken "
                         "on a CUDA device? A CPU trace carries none.")
    n = max(steps or len(loaded["step_ranges"]) or 1, 1)
    total_us = sum(e["dur"] for e in events)
    if total_us <= 0:
        raise SystemExit("the trace's device events carry no duration — truncated capture?")
    busy_us = _union_us(events)
    start = loaded["step_ranges"][0][0] if loaded["step_ranges"] else min(
        e["ts"] for e in events)
    window_us = max(e["ts"] + e["dur"] for e in events) - start
    peak = peak_flops(loaded["device"]) if loaded["device"] else None
    grouped = {}
    for e in events:
        key = (e["name"], e["source"])
        r = grouped.setdefault(key, {"name": e["name"], "source": e["source"],
                                     "category": e["category"],
                                     "entry_point": e["entry_point"], "total_us": 0.0,
                                     "occurrences": 0, "flops": None, "bytes": None})
        r["total_us"] += e["dur"]
        r["occurrences"] += 1
        for k in ("flops", "bytes"):
            if e[k] is not None:
                r[k] = (r[k] or 0) + e[k]
    rows = sorted(grouped.values(), key=lambda r: -r["total_us"])
    for r in rows:
        t_bytes = r["bytes"] / PEAK_BYTES if r["bytes"] is not None else None
        t_flops = r["flops"] / peak if r["flops"] is not None and peak else None
        known = [(t, label) for t, label in ((t_flops, "flops"), (t_bytes, "bytes"))
                 if t is not None]
        r["bound_by"] = max(known)[1] if known else None
        r["bound_us"] = max(known)[0] * 1e6 if known else None
        sec = r["total_us"] / 1e6
        r["gib_per_s"] = r["bytes"] / 2**30 / sec if r["bytes"] is not None and sec else None
        r["gflop_per_s"] = r["flops"] / 1e9 / sec if r["flops"] is not None and sec else None
    by_cat = collections.defaultdict(lambda: [0.0, 0])
    by_entry = collections.defaultdict(lambda: [0.0, 0])
    by_src = collections.defaultdict(float)
    for r in rows:
        by_cat[r["category"]][0] += r["total_us"]
        by_cat[r["category"]][1] += r["occurrences"]
        if r["category"] == "band attention":
            by_entry[r["entry_point"] or "?"][0] += r["total_us"]
            by_entry[r["entry_point"] or "?"][1] += r["occurrences"]
        by_src[r["source"]] += r["total_us"]
    return {"trace": loaded["trace"], "device": loaded["device"], "steps": n,
            "device_events": len(events), "device_us": total_us, "busy_us": busy_us,
            "window_us": window_us, "wall_ms_per_step": wall_ms,
            "attributed": loaded["attributed"],
            "categories": {k: {"us": v[0], "count": v[1]} for k, v in by_cat.items()},
            "band_attention": {k: {"us": v[0], "count": v[1]} for k, v in by_entry.items()},
            "sources": dict(by_src), "rows": rows}


def report(s: dict, top: int = 30, contains=None) -> None:
    n, total = s["steps"], s["device_us"]
    ms = lambda us: us / 1e3 / n  # noqa: E731
    print(f"# {s['trace']}: {s['device']}, {n} step(s), {s['device_events']} device "
          f"events; sources: {s['attributed']}")
    print("# roofline columns are estimates: flops of aten products (with_flops' formulas "
          "on recorded shapes), bytes a lower bound from recorded input shapes")
    print(f"device time: {ms(total):.3f} ms/step (kernels + memcpy + memset; "
          f"{total / 1e3:.1f} ms over {n} steps); busy (union) {ms(s['busy_us']):.3f} "
          f"ms/step; traced window {ms(s['window_us']):.3f} ms/step (host start to "
          f"device end), idle {1 - s['busy_us'] / s['window_us']:.1%} of it\n")
    print(f"{'category':<28}{'ms/step':>9}{'%':>7}{'#ops/step':>11}")
    for cat, v in sorted(s["categories"].items(), key=lambda kv: -kv[1]["us"]):
        print(f"{cat:<28}{ms(v['us']):>9.3f}{v['us'] / total * 100:>6.1f}%"
              f"{v['count'] / n:>11.1f}")
        if cat == "band attention":
            for entry, w in sorted(s["band_attention"].items(), key=lambda kv: -kv[1]["us"]):
                print(f"  {entry:<26}{ms(w['us']):>9.3f}{w['us'] / total * 100:>6.1f}%"
                      f"{w['count'] / n:>11.1f}")

    fmt = lambda x, spec: "?" if x is None else format(x, spec)  # noqa: E731
    print(f"\n{'ms/step':>8} {'%':>6} {'cum%':>6} {'n/st':>6} "
          f"{'bound':<6} {'GiB/s':>8} {'GF/s':>9}  op [source]")
    cum = 0.0
    for r in s["rows"][:top]:
        cum += r["total_us"]
        name = f"{r['name']} [{r['source']}]"
        name = name if len(name) <= 110 else name[:109] + "…"
        print(f"{ms(r['total_us']):>8.3f} {r['total_us'] / total * 100:>5.1f}% "
              f"{cum / total * 100:>5.1f}% {r['occurrences'] / n:>6.1f} "
              f"{r['bound_by'] or '?':<6} {fmt(r['gib_per_s'], '8.1f'):>8} "
              f"{fmt(r['gflop_per_s'], '9.1f'):>9}  {name}")

    print(f"\n{'ms/step':>8} {'%':>6}  source (innermost recommend_tpu_torch frame)")
    for src, us in sorted(s["sources"].items(), key=lambda kv: -kv[1])[:25]:
        print(f"{ms(us):>8.3f} {us / total * 100:>5.1f}%  {src}")

    if contains:
        print(f"\nops containing '{contains}':")
        for r in s["rows"]:
            if contains in r["name"]:
                print(f"{ms(r['total_us']):>8.3f} ms/step  {r['name']} [{r['source']}]")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="trace file, or a directory (its newest *.json)")
    ap.add_argument("--steps", type=int, default=None,
                    help="profiled steps in the window (default: its train_step ranges)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--contains", default=None,
                    help="also print every op whose name contains this")
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--wall-ms", type=float, default=None,
                    help="an untraced wall time a step, recorded in the --json dump")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    resolve_device(args.device, "analyze_profile")
    path = find_trace(args.path)
    print(f"# {path}", file=sys.stderr)
    s = summarize(load(path), args.steps, args.wall_ms)
    report(s, args.top, args.contains)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(s, f)
        print(f"\nwrote {args.json_out}", file=sys.stderr)
    return s


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
