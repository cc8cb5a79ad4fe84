"""Host ms a scan inside the program's `model` spans (FastScanPipeline.
stage2model: the host's dispatch of the model stage), over the `scan`
units the port's tracer recorded in the profiled part
(dram_tpu_torch.tracing). Nothing to read in a program without the
tracer."""


def read(ctx):
    if ctx["prof"] is None:
        return None
    try:
        from dram_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    units = {u["unit"] for u in snap["units"] if u["name"] == "scan"}
    if not units:
        return None
    return sum(s["host_ms"] for s in snap["spans"]
               if s["name"] == "model" and s["unit"] in units) / len(units)
