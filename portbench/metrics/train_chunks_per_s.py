"""Chunks through complete optimizer steps a second over the whole
window (host clock; the window ends in a device synchronize)."""


def read(ctx):
    if ctx["traffic"]["kind"] != "train_step":
        return None
    w = ctx["window"]
    return w["chunks"] / w["window_s"] if w["done"] else None
