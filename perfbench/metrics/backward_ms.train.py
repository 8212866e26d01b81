"""Device milliseconds a step of the program's ``backward`` span (its CUDA
events): the autograd backward, the zero-filled gradients, their reduction.
Over the recorded steps of the span phase (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "device_ms", "backward")
