"""Host-to-device copies a scan that wait for their stream: the
program's `h2d_copies` counter (core/ops.upload, the one way onto the
card of the scan path), over the `scan` units the port's tracer
recorded in the profiled part (dram_tpu_torch.tracing). Nothing to read
in a program without the tracer."""


def read(ctx):
    if ctx["prof"] is None:
        return None
    try:
        from dram_tpu_torch import tracing
    except ImportError:
        return None
    units = [u for u in tracing.snapshot()["units"] if u["name"] == "scan"]
    if not units:
        return None
    return sum(u["counters"].get("h2d_copies", 0)
               for u in units) / len(units)
