"""The least time the step's band attention needs (its work counted from
shapes for every layer, ``yardstick.flops.band_attention_work``, against
the card's bf16 and HBM peaks) over the device time of every layer's band
attention (``band_attn_ms.train``'s sources), in percent."""

from perfbench.yardstick.flops import band_attention_work
from perfbench.yardstick.peaks import least_seconds
from perfbench.yardstick.readers import BAND_ATTENTION, has_peak, source_ms


def read(ctx):
    ms = source_ms(ctx, BAND_ATTENTION)
    if ms is None or not has_peak(ctx):
        return None
    work = band_attention_work(ctx["cfg"], ctx["s_len"], ctx["traffic"]["batch_size"])
    return 100.0 * least_seconds(ctx["device_name"], work["flops"], work["bytes"]) / (ms / 1e3)
