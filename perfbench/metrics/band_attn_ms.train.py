"""Device milliseconds a step attributed to the band attention, whichever
route a layer takes: ``ops/flash_attention.py`` (its kernels, layout
copies and fallbacks) and ``ops/attention.py`` (the plain path and its
masks)."""

from perfbench.yardstick.readers import BAND_ATTENTION, source_ms


def read(ctx):
    return source_ms(ctx, BAND_ATTENTION)
