"""The numbers that decide a training cell's ``correct``, from two sets of
readings of the same first steps (each a dict with ``loss``: the steps'
losses, ``first``: per parameter the first gradient as the optimizer took
it, ``rows``: per table the rows the first step moved, ``change``: per
parameter the norm of the change over the steps; see
``reference.onetrans.reference_steps``).

Compared where the cell's limits file gives a limit:
- ``loss_gap``: the first step's |loss - reference| / reference;
- ``grad_gap``: the median parameter's |first - reference| / reference;
- ``grad_worst``: the worst parameter's |first - reference| over the larger
  of its reference and the median parameter's;
- ``rows_gap``: the worst table's |rows - reference| / reference;
- ``change_gap``: the median parameter's |change - reference| / reference.
The medians leave out the parameters whose reference gradient is under a
thousandth of the median parameter's (a key's bias under softmax moves by
round-off alone). The control (float8 products) reads ``grad_gap`` at three
times the program's largest or more (``grad_worst`` and ``loss_gap`` too,
in some cells); half of the batch leaves the norms nearly unchanged under
Zipf-skewed ids (the popular rows take the same gradient from either half)
and moves fewer rows; a dense learning rate a quarter too high reads
``change_gap`` at 0.25; a state left unchanged reads 1 in ``change_gap``
and ``rows_gap``.

The change is compared by its median, not its worst parameter: the worst
is most often a parameter of small gradients (an NS key stack), and the
steps after the first grow any difference there by orders of magnitude. On
the same seeds the program in float32 reads its first gradient 2e-7 from
the reference's and its change 2e-3; the reference itself with bfloat16
products reads the change of the program's order (0.36 against 0.32).
The later steps' losses are not compared: the first two steps of the
configurations' rmsprop scramble the model, and its losses after them swing
with any rounding. Reported beside, not compared: the worst change
(``change_worst``).
"""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Tuple

NAMES = ("loss_gap", "grad_gap", "grad_worst", "rows_gap", "change_gap")
NEGLIGIBLE = 1e-3  # of the median parameter's reference gradient


def _finite(gap: float) -> float:
    """A gap that is not a number (a NaN reading) as an infinite one."""
    return gap if gap == gap else float("inf")


def _gaps(got: Mapping[str, float], ref: Mapping[str, float], names) -> Dict[str, float]:
    """Each parameter's |got - ref| / ref."""
    return {n: _finite(abs(got[n] - ref[n]) / max(ref[n], 1e-30)) for n in names}


def _worst(got: Mapping[str, float], ref: Mapping[str, float], names) -> Tuple[float, str]:
    """The largest |got - ref| over the larger of ref and the median ref,
    and the parameter it was read at."""
    med = statistics.median(ref[n] for n in names)
    gaps = {n: _finite(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)) for n in names}
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def gaps(got: Mapping, ref: Mapping) -> Dict[str, object]:
    """The compared numbers, with the parameters the worst ones were read
    at, the numbers reported beside them and the parameters left out."""
    names = sorted(ref["first"])
    med = statistics.median(ref["first"][n] for n in names)
    moved = [n for n in names if ref["first"][n] >= NEGLIGIBLE * med]
    grad_worst, grad_at = _worst(got["first"], ref["first"], names)
    change_worst, change_at = _worst(got["change"], ref["change"], moved)
    loss = _finite(abs(got["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]), 1e-30))
    return {"grad_gap": statistics.median(_gaps(got["first"], ref["first"], moved).values()),
            "grad_worst": grad_worst,
            "rows_gap": max(_gaps(got["rows"], ref["rows"], sorted(ref["rows"])).values()),
            "change_gap": statistics.median(_gaps(got["change"], ref["change"], moved).values()),
            "grad_at": grad_at, "change_worst": change_worst, "change_at": change_at,
            "loss_gap": loss, "left_out": [n for n in names if n not in moved]}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number that has a limit at or under it (no limits: false)."""
    return bool(limits) and all(numbers[n] <= lim for n, lim in limits.items())
