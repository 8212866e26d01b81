"""Device milliseconds a step of the program's ``compression`` span (its
CUDA events): the adaptive compression's group encoders and pools, in the
forward pass (its backward runs on the autograd engine's thread, inside
``backward``). Over the recorded steps of the span phase."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "device_ms", "compression")
