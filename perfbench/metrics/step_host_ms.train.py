"""Host milliseconds a step of the program's ``train_step`` span
(``training/ranking_trainer.py``): its dispatch of the step.
Over the recorded steps of the span phase (``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    return reading(ctx, "host_ms", "train_step")
