"""Device milliseconds a step attributed to ``ops/normalization.py``."""

from perfbench.yardstick.readers import source_ms


def read(ctx):
    return source_ms(ctx, ["ops/normalization.py"])
