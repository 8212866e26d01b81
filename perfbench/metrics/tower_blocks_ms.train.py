"""Device milliseconds a step of the program's ``tower_blocks`` span (its
CUDA events): the retrieval tower's main stack of blocks, in the forward
pass. Over the recorded steps of the span phase."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "device_ms", "tower_blocks")
