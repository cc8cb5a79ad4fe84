"""The whole set-up, from the process's start to the window's: imports,
the kernel library (built on a checkout's first run), weights, inputs,
prep and warm-up (host clock), s."""


def read(ctx):
    return ctx["setup_s"]
