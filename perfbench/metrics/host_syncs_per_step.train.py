"""Host-device synchronisations a step inside the program's ``train_step``
span (its ``host_syncs`` counter).
Over the recorded steps of the span phase (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "counts", "host_syncs")
