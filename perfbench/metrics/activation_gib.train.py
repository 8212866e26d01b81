"""GiB a step holds for its backward: the device bytes allocated at the
end of the program's ``forward`` span beyond those at the start of
``train_step`` (its ``activation_bytes`` counter), over the span phase's
recorded steps (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    b = reading(ctx, "counts", "activation_bytes")
    return None if b is None else b / 2**30
