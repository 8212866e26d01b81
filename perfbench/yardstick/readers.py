"""Helpers of the metric readers under ``metrics/``: each reader's
``read(ctx)`` takes the run's context (the runner's readings with ``cfg``,
``traffic`` and ``device_name``) and returns a number, or None where the
run holds nothing for it to read."""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

from perfbench.yardstick.peaks import PEAKS

# where the step's band attention runs, whichever route a layer takes: the
# kernels' dispatch with its layout copies (ops/flash_attention.py) and the
# plain path with its masks (ops/attention.py)
BAND_ATTENTION = ("ops/flash_attention.py", "ops/attention.py")


def source_ms(ctx: Mapping, files: Iterable[str]) -> Optional[float]:
    """Device milliseconds a step attributed to sources in ``files`` (paths
    under ``recommend_tpu_torch/``), from the traced run; None untraced or
    where nothing ran there."""
    sources = ctx.get("sources")
    if not sources:
        return None
    files = tuple(files)
    hits = [s for src, s in sources.items() if src.split(":", 1)[0] in files]
    return sum(hits) * 1e3 if hits else None


def has_peak(ctx: Mapping) -> bool:
    """Whether the card has a row in the table of peaks (a CPU run has none)."""
    return ctx.get("device_name") in PEAKS
