"""Device milliseconds a step attributed to ``ops/sparse_embed.py`` (the
lookups' dummies and the touched-row table updates)."""

from perfbench.yardstick.readers import source_ms


def read(ctx):
    return source_ms(ctx, ["ops/sparse_embed.py"])
