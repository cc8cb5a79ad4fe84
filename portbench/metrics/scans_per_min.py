"""Scans completed a minute over the whole window (host clock)."""

from portbench.lib import harness


def read(ctx):
    if harness.family(ctx["traffic"]) != "scan":
        return None
    w = ctx["window"]
    return 60.0 * w["done"] / w["window_s"] if w["done"] else None
