"""Device idle milliseconds a step whose gap ends at a kernel launched
inside the program's ``optimizer`` span, in the span phase's profiled steps
(``yardstick/spans.py``); 0 where no gap is under it."""

from perfbench.yardstick.spans import reading


def read(ctx):
    if not reading(ctx, "profiled", "device_events"):
        return None
    return reading(ctx, "profiled", "idle_ms").get("optimizer", 0.0)
