"""Host ms a scan inside the program's `scan` unit (FastScanPipeline.
process_chunks: the host's dispatch of the scan's stages, its waits on
the card included), over the scans the port's tracer recorded
(dram_tpu_torch.tracing; it records while the profiler does, so these
are the profiled part's scans). Nothing to read in a program without
the tracer."""


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
    return sum(u["host_ms"] for u in units) / len(units)
