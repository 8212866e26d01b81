"""The port's tracing: the recorder of spans and counters inside a step, and
``StepProfiler``, a ``torch.profiler`` window of training steps.

The recorder is off by default. Off, ``span`` and ``count`` check one flag
and return: nothing is allocated, launched or synchronised. Turned on for a
block by ``recording()``, it keeps in memory

- spans: each with its name, its parent span, the step it belongs to, host
  start and end (``time.perf_counter_ns``) and, where a card is present, a
  pair of timing CUDA events whose device times ``export()`` gives relative
  to the step's first event. Each span also enters a
  ``torch.profiler.record_function`` range of its name, so that under any
  profiler session the spans lie on the trace's own clock (as
  ``user_annotation`` events, and ``gpu_user_annotation`` ranges over the
  kernels their thread launched). A span opened with ``step=`` opens a step:
  its range is named ``<name>_<step>`` and the spans inside it take its
  step number; on a card it counts the host-device synchronisations inside
  it (``host_syncs``, with ``torch.cuda.set_sync_debug_mode("warn")`` for
  its duration) and is the base of ``count_allocated``;
- counts: a name, an optional key (a table's name), the step and span they
  fell in, and a value, a Python number or a device tensor read only at
  ``export()``;
- registered counters (``register``): dicts the program keeps itself, such
  as ``ops/flash_attention.LAUNCHES``, reported as they stand at export.

``export()`` synchronises once, reads every device value and returns the
records as plain data, then forgets them::

    with profiling.recording():
        for batch in batches:
            state, metrics = trainer._train_step(state, batch)
    records = profiling.export()

A ``StepProfiler`` traces steps [start_step, start_step + num_steps) of a
loop, CPU and (when a card is present) CUDA activity, with the recorder on,
so that each step's spans mark the trace, and exports a Chrome trace,
``trace_<start>-<stop>.json``, into ``log_dir`` when the window closes. It
does nothing, and allocates nothing per step, when ``log_dir`` is None.

    prof = StepProfiler("/tmp/run/profile", start_step=10, num_steps=5)
    for i in range(num_steps):
        with prof.step(i):
            state, metrics = train_step(state, batch)
    prof.close()

Open the trace in ``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional

import torch

_OFF = contextlib.nullcontext()
# what torch.cuda.set_sync_debug_mode("warn") says at each synchronisation
_SYNC_WARNING = "called a synchronizing CUDA operation"


class _Span:
    """One span while it is open (see the module's docstring)."""

    __slots__ = ("rec", "name", "step", "opens_step", "index", "parent", "root", "t0", "t1",
                 "ev0", "ev1", "range", "alloc0", "warn", "log", "sync_mode")

    def __init__(self, rec: "Recorder", name: str, step: Optional[int]):
        self.rec, self.name, self.step = rec, name, step
        self.opens_step = step is not None
        self.ev0 = self.ev1 = None

    def __enter__(self):
        rec = self.rec
        self.parent = rec.stack[-1].index if rec.stack else None
        if self.opens_step:
            self.root = self
            rec.step_span = self
            if rec.cuda:
                self.alloc0 = torch.cuda.memory_allocated()
                self.warn = warnings.catch_warnings(record=True)
                self.log = self.warn.__enter__()
                warnings.simplefilter("always")
                self.sync_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        else:
            self.root = rec.step_span
            self.step = self.root.step if self.root is not None else None
        self.index = len(rec.spans)
        rec.spans.append(self)
        rec.stack.append(self)
        self.t0 = time.perf_counter_ns()
        self.range = torch.profiler.record_function(
            f"{self.name}_{self.step}" if self.opens_step else self.name)
        self.range.__enter__()
        if rec.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.cuda:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.range.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        rec.stack.pop()
        if self.opens_step:
            rec.step_span = None
            if rec.cuda:
                torch.cuda.set_sync_debug_mode(self.sync_mode)
                self.warn.__exit__(*exc)
                syncs = 0
                for w in self.log:  # the step's other warnings, as they were raised
                    if _SYNC_WARNING in str(w.message):
                        syncs += 1
                    else:
                        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
                rec.counts.append(("host_syncs", None, self.step, self.index, syncs))
        return False


class Recorder:
    """Spans, counts and registered counters (see the module's docstring)."""

    def __init__(self):
        self.on = False
        self.cuda = False
        self.registered: Dict[str, Mapping[str, Any]] = {}
        self._clear()

    def _clear(self) -> None:
        self.spans: List[_Span] = []
        self.counts: List[tuple] = []
        self.stack: List[_Span] = []
        self.step_span: Optional[_Span] = None

    @contextlib.contextmanager
    def recording(self):
        """The recorder on over the block, the last block's records
        forgotten; inside a block already on, nothing changes."""
        if self.on:
            yield self
            return
        self._clear()
        self.cuda = torch.cuda.is_available()
        self.on = True
        try:
            yield self
        finally:
            self.on = False

    def count(self, name: str, value, key: Optional[str] = None) -> None:
        span = self.stack[-1].index if self.stack else None
        step = self.step_span.step if self.step_span is not None else None
        self.counts.append((name, key, step, span, value))

    def export(self) -> Dict[str, Any]:
        """The records since the recorder was turned on (or the last
        export), as plain data, then forgotten: ``spans`` (name, parent
        index, step, host ns, device ms from the step's first event),
        ``counts`` (name, key, step, span index, value) and ``registered``
        (each registered counter as it stands)."""
        if self.stack:
            raise RuntimeError(f"export() inside the open span {self.stack[-1].name!r}")
        if any(s.ev0 is not None for s in self.spans):
            torch.cuda.synchronize()
        spans = []
        for s in self.spans:
            d = {"name": s.name, "parent": s.parent, "step": s.step,
                 "host_start_ns": s.t0, "host_end_ns": s.t1}
            if s.ev0 is not None and s.root is not None:
                d["device_start_ms"] = s.root.ev0.elapsed_time(s.ev0)
                d["device_end_ms"] = s.root.ev0.elapsed_time(s.ev1)
            spans.append(d)
        counts = [{"name": n, "key": k, "step": st, "span": sp,
                   "value": v.item() if isinstance(v, torch.Tensor) else v}
                  for n, k, st, sp, v in self.counts]
        self._clear()
        return {"spans": spans, "counts": counts,
                "registered": {n: dict(c) for n, c in self.registered.items()}}


RECORDER = Recorder()


def recording():
    """``RECORDER`` on over a ``with`` block."""
    return RECORDER.recording()


def is_recording() -> bool:
    """Whether the recorder is on: the guard of a count whose value costs
    work to compute."""
    return RECORDER.on


def span(name: str, step: Optional[int] = None):
    """A span over a ``with`` block; ``step`` opens a step."""
    return _Span(RECORDER, name, step) if RECORDER.on else _OFF


def count(name: str, value, key: Optional[str] = None) -> None:
    """Count ``value`` (a number, or a device tensor read at export) under
    ``name`` and ``key``."""
    if RECORDER.on:
        RECORDER.count(name, value, key)


def count_allocated(name: str) -> None:
    """Count the device bytes allocated now beyond those allocated when the
    open step began (on a card, inside a step)."""
    rec = RECORDER
    if rec.on and rec.cuda and rec.step_span is not None:
        rec.count(name, torch.cuda.memory_allocated() - rec.step_span.alloc0)


def register(name: str, counters: Mapping[str, Any]) -> None:
    """Report the program's own ``counters`` (kept and raised by the
    program) under ``name`` in every export."""
    RECORDER.registered[name] = counters


def export() -> Dict[str, Any]:
    """``RECORDER``'s records, then forgotten (``Recorder.export``)."""
    return RECORDER.export()


class StepProfiler:
    def __init__(self, log_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop_at = start_step + num_steps
        self._prof = None
        self._rec = None

    def step(self, i: int):
        """Context manager for step ``i`` (0-based loop index); the step's
        own spans mark it in the trace."""
        if self.log_dir is None:
            return _OFF
        if self._prof is None and self.start <= i < self.stop_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._rec = recording()
            self._rec.__enter__()
        elif self._prof is not None and i >= self.stop_at:
            self.close()
        return _OFF

    def close(self) -> None:
        """End the window (if the loop ended inside it) and export its
        trace."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        rec, self._rec = self._rec, None
        rec.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.log_dir, f"trace_{self.start}-{self.stop_at}.json"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
