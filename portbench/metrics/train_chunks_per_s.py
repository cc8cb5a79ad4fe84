"""Chunks through complete optimizer steps a second over the whole
window (host clock; the window ends in a device synchronize)."""

from portbench.lib import harness


def read(ctx):
    if harness.family(ctx["traffic"]) != "train":
        return None
    w = ctx["window"]
    return w["chunks"] / w["window_s"] if w["done"] else None
