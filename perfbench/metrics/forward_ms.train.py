"""Device milliseconds a step of the program's ``forward`` span (its CUDA
events): the dummies, the model and the loss.
Over the recorded steps of the span phase (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "device_ms", "forward")
