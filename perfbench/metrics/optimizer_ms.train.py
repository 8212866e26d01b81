"""Device milliseconds a step attributed to ``training/optimizer.py`` (the
clip and the dense rule)."""

from perfbench.yardstick.readers import source_ms


def read(ctx):
    return source_ms(ctx, ["training/optimizer.py"])
