"""``torch.profiler`` over a window of training steps: the port's
``utils/profiling.StepProfiler``.

A ``StepProfiler`` traces steps [start_step, start_step + num_steps) of a
loop, CPU and (when a card is present) CUDA activity, marks each step with a
``record_function`` range, and exports a Chrome trace,
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
from typing import Optional

import torch


class StepProfiler:
    def __init__(self, log_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop_at = start_step + num_steps
        self._prof = None

    def step(self, i: int):
        """Context manager for step ``i`` (0-based loop index)."""
        if self.log_dir is None:
            return contextlib.nullcontext()
        if self._prof is None and self.start <= i < self.stop_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and i >= self.stop_at:
            self.close()
        if self._prof is not None:
            return torch.profiler.record_function(f"train_step_{i}")
        return contextlib.nullcontext()

    def close(self) -> None:
        """End the window (if the loop ended inside it) and export its
        trace."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.log_dir, f"trace_{self.start}-{self.stop_at}.json"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
