"""Device kernels, copies and memsets a step in the device-only profile."""


def read(ctx):
    prof = ctx.get("profile")
    return prof["launches"] / prof["steps"] if prof else None
