"""Structured metric logging, the port's copy of the JAX package's
``utils/logging.MetricLogger`` (stdlib only): every metric goes to stdout
and, when a log dir is given, to an append-only JSONL file per stream. The
TensorBoard writer of the original is left out."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, quiet: bool = False):
        self.log_dir = log_dir
        self.quiet = quiet
        self._files = {}
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def _file(self, stream: str):
        if self.log_dir is None:
            return None
        if stream not in self._files:
            self._files[stream] = open(
                os.path.join(self.log_dir, f"{stream}.jsonl"), "a"
            )
        return self._files[stream]

    def log(self, stream: str, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        f = self._file(stream)
        if f is not None:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        if not self.quiet:
            shown = ", ".join(
                f"{k}={v:.4g}" for k, v in metrics.items() if isinstance(v, float)
            )
            print(f"[{stream}] step {step}: {shown}")

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}
