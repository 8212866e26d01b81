"""The share of the profiled steps' span, first device event to last, in
which no kernel, copy or memset ran on the card, in percent."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
