"""Scans completed a minute over the whole window (host clock)."""


def read(ctx):
    if ctx["traffic"]["kind"] != "scan_infer":
        return None
    w = ctx["window"]
    return 60.0 * w["done"] / w["window_s"] if w["done"] else None
