"""The program's own spans and counters over a phase of the retrieval
trainer's steps, run on the run's own trainer and state once its profiles
are taken (``workloads/retrieval_train.py``), reduced as
``yardstick/spans.py`` reduces the ranking trainer's, so that the readers
of ``metrics/`` read either through ``spans.reading``.

With nothing compiled in it that the run had not compiled:

1. the recorder's cost: ``spans.SPAN_STEPS`` steps with the recorder off,
   then on, twice over (``spans._block``); the two recorded blocks give the
   spans' host and device (CUDA event) times and the counts;
2. ``SPAN_STEPS`` steps with the recorder on under a CPU and CUDA profile
   without stacks, whose idle gaps go under the innermost span open on the
   step's thread when the kernel that ends the gap was launched
   (``spans.idle_by_span``).

Where the program has no recorder, nothing runs and it gives None.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import torch

from perfbench.yardstick.spans import SPAN_STEPS, _block, _report, idle_by_span, reduce_exports


def run_phase(trainer, state, batches, start: int, device) -> Tuple[Optional[Dict], object]:
    """(the span phase's readings, or None where the program has no
    recorder; the state after it), from step ``start`` of the placed
    ``batches``."""
    from recommend_tpu_torch.utils import profiling

    if not hasattr(profiling, "recording"):
        return None, state
    k = start
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
    _report(out)
    return out, state
