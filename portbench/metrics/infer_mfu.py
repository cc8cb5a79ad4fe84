"""The model's FLOPs a scan (2 x the conv stacks' MACs of each of the
scan's lobe chunks) times the profiled scans, over the device time they
span in the trace (the first operation's start to the last one's end,
idle gaps included), over the card's bf16 peak, %."""

from portbench.lib import convcount, peaks


def read(ctx):
    p = ctx["prof"]
    if p is None or ctx["traffic"]["kind"] != "scan_infer" or \
            not p["units"] or p["span_s"] <= 0:
        return None
    cfg = ctx["config"]["values"]
    chunks = len(ctx["traffic"]["lesion_severity"])
    flops = convcount.model_flops(cfg["MODEL"], cfg["RESAMPLE_SIZE"][0])
    return 100.0 * p["units"] * chunks * flops / p["span_s"] \
        / peaks.BF16_FLOPS
