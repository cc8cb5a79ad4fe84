"""95th percentile of every scan's latency in the window, from its
dispatch to its mask on the host (host clock), ms."""

import numpy as np

from portbench.lib import harness


def read(ctx):
    if harness.family(ctx["traffic"]) != "scan":
        return None
    lat = ctx["window"]["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
