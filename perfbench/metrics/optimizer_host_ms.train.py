"""Host milliseconds a step of the program's ``optimizer`` span: the clip
and the dense rule (``training/optimizer.py``) dispatched.
Over the recorded steps of the span phase (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "host_ms", "optimizer")
