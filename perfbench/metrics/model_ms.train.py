"""Device milliseconds a step attributed to the model's own code outside
the attention: ``models/ranking.py``, ``models/tokenizer.py`` and
``models/losses.py``."""

from perfbench.yardstick.readers import source_ms


def read(ctx):
    return source_ms(ctx, ["models/ranking.py", "models/tokenizer.py", "models/losses.py"])
