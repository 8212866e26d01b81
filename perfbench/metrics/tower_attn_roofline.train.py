"""The least time the retrieval tower's attention needs (its work at the
pairs the interleaved mask and the groups' padding masks allow, counted
from shapes by ``yardstick.retrieval_flops.attention_work``, against the
card's bf16 and HBM peaks) over the device time of ``tower_attn_ms.train``,
in percent."""

from perfbench.yardstick.peaks import least_seconds
from perfbench.yardstick.readers import has_peak, source_ms
from perfbench.yardstick.retrieval_flops import attention_work


def read(ctx):
    ms = source_ms(ctx, ["ops/attention.py"])
    if ms is None or not has_peak(ctx):
        return None
    traffic = ctx["traffic"]
    work = attention_work(ctx["cfg"], traffic["batch_size"], traffic["mode"])
    return 100.0 * least_seconds(ctx["device_name"], work["flops"], work["bytes"]) / (ms / 1e3)
