"""Examples trained in the window over its seconds (first dispatch to the
barrier)."""


def read(ctx):
    return ctx["examples"] / ctx["seconds"]
