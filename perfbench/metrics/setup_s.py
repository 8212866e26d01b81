"""Seconds from the process's start to the window's: imports, kernels
loaded (or built, in a checkout's first run), weights and batches drawn and
placed, the checked and warm steps."""


def read(ctx):
    return ctx["setup_s"]
