"""Device milliseconds a step attributed to ``ops/attention.py``, the
retrieval tower's attention (its products, masks and softmax, forward and
backward), in the compression's encoders and the main stack alike."""

from perfbench.yardstick.readers import source_ms


def read(ctx):
    return source_ms(ctx, ["ops/attention.py"])
