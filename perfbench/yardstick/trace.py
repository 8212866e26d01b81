"""Reduce a ``torch.profiler`` Chrome trace of training steps to per-layer
numbers: device time by source, launches, busy and idle time, and the
breakdown a run reports.

Attribution (from the repository's profile analysis, frozen here so that a
change to the program cannot move the yardstick): a device event is followed
through its ``correlation`` id to the runtime launch with the same id, then
to the innermost ``python_function`` frame inside ``recommend_tpu_torch/``
enclosing that launch on the launch's thread. A kernel of an autograd
backward op has no Python frame (it is launched from the engine's thread);
it takes the frame of its forward op, found through the trace's ``fwdbwd``
flow, or failing that the ``Sequence number`` / ``Fwd thread id`` args.
A source is ``<file under recommend_tpu_torch/>:<function>``.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import re
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_FRAME = re.compile(r"(?:^|/)recommend_tpu_torch/(\S+?\.py)\((\d+)\): (.*)$")
_ANY_FRAME = re.compile(r"^(\S+?\.py)\((\d+)\): (.*)$")


def repo_frame(frames) -> Optional[str]:
    """``file:function`` of the innermost frame inside recommend_tpu_torch/
    (``frames`` outermost first), or None."""
    for f in reversed(frames):
        m = _FRAME.search(f)
        if m:
            return f"{m.group(1)}:{m.group(3)}"
    return None


def _any_frame(frames) -> str:
    if not frames:
        return "?"
    m = _ANY_FRAME.match(frames[-1])
    return f"{m.group(1).rsplit('/', 1)[-1]}:{m.group(3)}" if m else frames[-1]


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


def load_events(trace_path: str) -> dict:
    """The trace's device events, each with its attributed source, and for
    each idle gap between them what the host was doing."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    devices = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: e["ts"])
    launches = {}
    frames = collections.defaultdict(list)
    ops = collections.defaultdict(list)
    flow_end, flow_start = {}, {}
    fwd_ops = collections.defaultdict(list)  # sequence number -> forward ops
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
    for v in fwd_ops.values():
        v.sort()

    launch_of = [launches.get(d.get("args", {}).get("correlation")) for d in devices]
    by_thread = collections.defaultdict(list)
    for i, ev in enumerate(launch_of):
        if ev is not None:
            by_thread[(ev["pid"], ev["tid"])].append(i)
    op_stack = [()] * len(devices)
    for key, idx in by_thread.items():
        for i, st in zip(idx, _stacks(ops[key], [launch_of[i]["ts"] for i in idx])):
            op_stack[i] = st

    def forward_point(op_events):
        for op in reversed(op_events):
            a = op.get("args", {})
            fid = flow_end.get((op["pid"], op["tid"], op["ts"]))
            if fid is not None and fid in flow_start:
                return flow_start[fid]
            if a.get("Fwd thread id") and "Sequence number" in a:
                cands = fwd_ops.get(a["Sequence number"], [])
                k = bisect.bisect_left(cands, (op["ts"],)) - 1
                if k >= 0:
                    ts, pid, tid = cands[k]
                    return (pid, tid, ts)
        return None

    queries = collections.defaultdict(list)  # thread -> [(time, device index, kind)]
    for i, ev in enumerate(launch_of):
        if ev is None:
            continue
        queries[(ev["pid"], ev["tid"])].append((ev["ts"], i, "launch"))
        point = forward_point(op_stack[i])
        if point is not None:
            queries[(point[0], point[1])].append((point[2], i, "forward"))
    stacks = {"launch": [()] * len(devices), "forward": [()] * len(devices)}
    for key, qs in queries.items():
        for (_, i, kind), st in zip(qs, _stacks(frames[key], [q[0] for q in qs])):
            stacks[kind][i] = st

    rows = []
    for i, d in enumerate(devices):
        source = repo_frame(stacks["forward"][i]) or repo_frame(stacks["launch"][i])
        rows.append({"name": d.get("name", "?"), "cat": d.get("cat"),
                     "source": source or "(outside recommend_tpu_torch)",
                     "ts": float(d["ts"]), "dur": float(d.get("dur", 0))})

    # the idle gaps, and what the host was doing when it launched the op
    # that ends each: the launching thread's innermost recommend_tpu_torch
    # frame, else its innermost aten op, else its innermost frame
    gaps = []
    end = -math.inf
    for i, r in enumerate(rows):
        if r["ts"] > end and end > -math.inf and launch_of[i] is not None:
            gaps.append((end, r["ts"], i))
        end = max(end, r["ts"] + r["dur"])
    gap_queries = collections.defaultdict(list)
    for g0, g1, i in gaps:
        ev = launch_of[i]
        gap_queries[(ev["pid"], ev["tid"])].append((ev["ts"], g0, g1))
    idle = []
    for key, qs in gap_queries.items():
        times = [q[0] for q in qs]
        fstacks = _stacks(frames[key], times)
        ostacks = _stacks([(s, e, ev["name"]) for s, e, ev in ops[key]], times)
        for (_, g0, g1), fs, os_ in zip(qs, fstacks, ostacks):
            label = repo_frame(fs) or (os_[-1] if os_ else _any_frame(fs))
            idle.append((label, (g1 - g0) * 1e-6))
    return {"events": rows, "idle": idle}


def busy_and_window(rows: List[dict]) -> Dict[str, float]:
    """Seconds in which a device event ran (their union) and the span from
    the first event's start to the last one's end."""
    if not rows:
        return {"busy_s": 0.0, "window_s": 0.0}
    busy, end = 0.0, -math.inf
    for r in sorted(rows, key=lambda r: r["ts"]):
        s, e = r["ts"], r["ts"] + r["dur"]
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    start = min(r["ts"] for r in rows)
    stop = max(r["ts"] + r["dur"] for r in rows)
    return {"busy_s": busy * 1e-6, "window_s": (stop - start) * 1e-6}


def by_source(rows: List[dict], steps: int) -> Dict[str, float]:
    """Device seconds a step by attributed source."""
    out = collections.defaultdict(float)
    for r in rows:
        out[r["source"]] += r["dur"] * 1e-6 / steps
    return dict(out)


def top(pairs, steps: int, n: int = 10) -> List[list]:
    """The ``n`` labels of (label, seconds) pairs with the most seconds a
    step, most first."""
    out = collections.defaultdict(float)
    for label, s in pairs:
        out[label] += s / steps
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]
