"""The whole step's share of the card's dense bf16 peak, in percent: model
FLOPs of the window's steps (attention at the band's allowed pairs, three
forwards a step) over the window's seconds times the peak."""

from perfbench.yardstick.peaks import peak
from perfbench.yardstick.readers import has_peak


def read(ctx):
    if not has_peak(ctx):
        return None
    flops = ctx["flops_per_step"] * ctx["steps"]
    return 100.0 * flops / (ctx["seconds"] * peak(ctx["device_name"], "bf16_flops"))
