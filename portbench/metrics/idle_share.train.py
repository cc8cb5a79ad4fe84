"""The share of the profiled part of the window in which no operation
ran on the device: 1 - the union of the device's operations over the
part's length (host clock, between two device synchronizes), %."""


def read(ctx):
    p = ctx["prof"]
    if p is None or ctx["traffic"]["kind"] != "train_step" or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
