"""The conv kernels' share of their roofline over the profiled scans:
the sum of each eval conv launch's bound (bf16 operations at 989
TFLOP/s or bytes at 3.35 TB/s, whichever is larger; lib/convcount.py)
over the sum of the conv kernels' device time, %. The launch count must
be 14 a scan (one c1 and 13 wgmma launches in the flagship)."""

from portbench.lib import convcount


def read(ctx):
    p = ctx["prof"]
    if p is None or ctx["traffic"]["kind"] != "scan_infer":
        return None
    cfg = ctx["config"]["values"]
    size = cfg["RESAMPLE_SIZE"][0]
    launches = convcount.eval_launches(cfg["MODEL"], size)
    return convcount.roofline_share(
        p["device_ops"], launches, len(ctx["traffic"]["lesion_severity"]),
        p["units"])
