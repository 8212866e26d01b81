"""The program's own spans and counters (the recorder of
``recommend_tpu_torch/utils/profiling.py``) over a phase of training steps,
and their reduction to per-step numbers for the readers under ``metrics/``.

The span phase runs once in a traced run, when the first of its readers
asks (``readings(ctx)``), after the run's own phases have been read and the
program's state freed. It builds the trainer again from the run's seed
(``workloads/train.build``: the same weights and batches) and runs, with
nothing compiled in it that the run had not compiled:

1. ``WARM_STEPS`` steps and a host fetch of the loss;
2. the recorder's cost: ``SPAN_STEPS`` steps with the recorder off, then
   on, twice over, each block timed on the host around each step's call
   and on the wall to a host fetch of its last loss. The two recorded
   blocks give the spans' host and device (CUDA event) times and the
   counts;
3. ``SPAN_STEPS`` steps with the recorder on under a CPU and CUDA profile
   without stacks: each idle gap of the card is put under the innermost
   span open on the step's thread when the kernel that ends the gap was
   launched (a backward kernel is launched from the autograd engine's
   thread while the step's thread waits inside ``backward``). A gap ended
   by a kernel launched outside every span is under ``OUTSIDE``.

Where the run was not traced, or the program has no recorder, nothing runs
and every reader reads None.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Mapping, Optional

import torch

from perfbench.yardstick.trace import DEVICE_CATS, LAUNCH_CATS, _stacks

SPAN_STEPS = 3
WARM_STEPS = 2
STEP = "train_step"
OUTSIDE = "(outside every span)"
_STEP_RANGE = re.compile(rf"^{STEP}_\d+$")


def _log(what: str) -> None:
    print(f"[perfbench spans] {what}", file=sys.stderr, flush=True)


def _span_name(range_name: str) -> str:
    """A range's span: ``train_step_<i>`` is step i's ``train_step``."""
    return STEP if _STEP_RANGE.match(range_name) else range_name


def reduce_exports(exports: List[Mapping]) -> Dict:
    """Per-step means of the recorder's exports: host ms by span name (and
    self ms: what its children do not cover), device ms by span name (CUDA
    events), counts by name (over keys) and their sums by name."""
    host, self_ms, device, sums = (collections.defaultdict(float) for _ in range(4))
    steps = 0
    for rec in exports:
        spans = rec["spans"]
        steps += sum(1 for s in spans if s["name"] == STEP and s["parent"] is None)
        for s in spans:
            if s["step"] is None:
                continue
            ms = (s["host_end_ns"] - s["host_start_ns"]) * 1e-6
            host[s["name"]] += ms
            self_ms[s["name"]] += ms
            if s["parent"] is not None:
                self_ms[spans[s["parent"]]["name"]] -= ms
            if "device_start_ms" in s:
                device[s["name"]] += s["device_end_ms"] - s["device_start_ms"]
        for c in rec["counts"]:
            if c["step"] is not None:
                sums[c["name"]] += c["value"]
    if not steps:
        return {"steps": 0}
    return {"steps": steps, "host_ms": {k: v / steps for k, v in host.items()},
            "self_ms": {k: v / steps for k, v in self_ms.items()},
            "device_ms": {k: v / steps for k, v in device.items()},
            "counts": {k: v / steps for k, v in sums.items()}, "sums": dict(sums)}


def idle_by_span(events: List[Mapping]) -> Dict:
    """The idle gaps of a Chrome trace's device events, each under the
    innermost span (``user_annotation`` range) open on a step's thread when
    the event ending it was launched, per ``train_step_<i>`` range:
    ``idle_ms`` by span, ``idle_total_ms``, and ``annotation_ms``, the
    ``gpu_user_annotation`` ranges by span."""
    devices = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ranges = collections.defaultdict(list)
    annotation = collections.defaultdict(float)
    step_threads, steps = set(), 0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation":
            name = _span_name(e["name"])
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), name))
            if name == STEP:
                step_threads.add((e["pid"], e["tid"]))
                steps += 1
        elif e.get("cat") == "gpu_user_annotation":
            annotation[_span_name(e["name"])] += e.get("dur", 0)
    gaps = []
    end = -math.inf
    for d in devices:
        if end > -math.inf and d["ts"] > end:
            gaps.append((d["ts"] - end, d))
        end = max(end, d["ts"] + d.get("dur", 0))
    keys = [OUTSIDE] * len(gaps)
    queries = [(launches[c]["ts"], i) for i, (_, d) in enumerate(gaps)
               if (c := d.get("args", {}).get("correlation")) in launches]
    for thread in step_threads:
        for (_, i), st in zip(queries, _stacks(ranges[thread], [t for t, _ in queries])):
            if st:
                keys[i] = st[-1]
    idle = collections.defaultdict(float)
    for (gap, _), key in zip(gaps, keys):
        idle[key] += gap
    if not steps:
        return {"steps": 0}
    return {"steps": steps, "device_events": len(devices),
            "idle_ms": {k: v * 1e-3 / steps for k, v in idle.items()},
            "idle_total_ms": sum(idle.values()) * 1e-3 / steps,
            "annotation_ms": {k: v * 1e-3 / steps for k, v in annotation.items()}}


def _seed(ctx: Mapping) -> int:
    """The run's ``--seed`` (from its command line; 0 where there is none)."""
    if "seed" in ctx:
        return ctx["seed"]
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _block(trainer, state, batches, start: int, recorder):
    """``SPAN_STEPS`` steps inside ``recorder`` (a context); (state, host ms
    a step around the calls, wall ms a step to a host fetch of the last
    loss)."""
    host = 0.0
    t0 = time.perf_counter()
    with recorder:
        for i in range(SPAN_STEPS):
            h0 = time.perf_counter()
            state, m = trainer._train_step(state, batches[(start + i) % len(batches)])
            host += time.perf_counter() - h0
        float(m["loss"])
    wall = time.perf_counter() - t0
    return state, host * 1e3 / SPAN_STEPS, wall * 1e3 / SPAN_STEPS


def run_phase(cfg: Mapping, traffic: Mapping, seed: int, device) -> Optional[Dict]:
    """The span phase (the module's docstring) on ``device``; None where the
    program has no recorder."""
    from recommend_tpu_torch.utils import profiling

    if not hasattr(profiling, "recording"):
        return None
    from perfbench.workloads.train import _free, build

    trainer, state, batches = build(cfg, traffic, seed, device)
    for k in range(WARM_STEPS):
        state, m = trainer._train_step(state, batches[k % len(batches)])
    float(m["loss"])
    k = WARM_STEPS
    cost = {"off": [], "on": []}
    exports = []
    for mode in ("off", "on", "off", "on"):
        rec = profiling.recording() if mode == "on" else contextlib.nullcontext()
        state, host, wall = _block(trainer, state, batches, k, rec)
        k += SPAN_STEPS
        cost[mode].append({"host_ms": host, "wall_ms": wall})
        if mode == "on":
            exports.append(profiling.export())
    out = reduce_exports(exports)
    out["cost"] = cost

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="perfbench-spans-")
    path = os.path.join(tmp, "spans.json")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            state, _, _ = _block(trainer, state, batches, k, profiling.recording())
        profiled = reduce_exports([profiling.export()])
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            out["profiled"] = {**idle_by_span(json.load(f).get("traceEvents", [])),
                               "device_ms": profiled.get("device_ms", {})}
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    del trainer, state, batches
    _free(device)
    return out


def _report(r: Mapping) -> None:
    """What the acceptance of the spans reads, on standard error: the
    phases' device ms against the step's, the events against the trace's
    ranges, the idle under each span, the recorder's cost."""
    dev = r.get("device_ms", {})
    if dev.get(STEP):
        parts = sum(dev.get(n, 0.0) for n in ("forward", "backward", "optimizer",
                                              "sparse_update"))
        _log(f"device ms a step {json.dumps(dev)}; the phases sum to "
             f"{100 * parts / dev[STEP]:.2f}% of {STEP}")
    _log(f"host ms a step {json.dumps(r.get('host_ms'))}; self {json.dumps(r.get('self_ms'))}")
    _log(f"counts a step {json.dumps(r.get('counts'))}")
    _log(f"the recorder's cost {json.dumps(r.get('cost'))}")
    p = r.get("profiled", {})
    if p.get("steps"):
        total = p["idle_total_ms"]
        shares = {k: 100 * v / total for k, v in p["idle_ms"].items()} if total else {}
        _log(f"profiled: idle {total:.3f} ms a step, % by span {json.dumps(shares)}")
        _log(f"profiled: CUDA-event ms {json.dumps(p['device_ms'])}; gpu_user_annotation ms "
             f"{json.dumps(p['annotation_ms'])}")


def readings(ctx: Dict) -> Optional[Dict]:
    """The span phase's readings for the run of ``ctx``, run on the first
    call and kept in ``ctx["spans"]``; None untraced or where the program
    has no recorder."""
    if "spans" not in ctx:
        if not ctx.get("profile"):
            return None
        device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
        ctx["spans"] = run_phase(ctx["cfg"], ctx["traffic"], _seed(ctx), device)
        if ctx["spans"] is not None:
            _report(ctx["spans"])
    return ctx["spans"]


def reading(ctx: Dict, *path: str) -> Optional[float]:
    """``readings(ctx)`` at ``path`` (e.g. ``"host_ms", "optimizer"``), or
    None where the run has nothing there."""
    r = readings(ctx)
    for key in path:
        if not isinstance(r, Mapping) or key not in r:
            return None
        r = r[key]
    return r
