"""Device milliseconds a step of the program's ``in_batch_loss`` span (its
CUDA events): the in-batch softmaxes with LogQ and label smoothing, in the
forward pass. Over the recorded steps of the span phase."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "device_ms", "in_batch_loss")
