"""Device ms a step in the program's `pcm` span (DC3DATGeneric.
apply_attention's forward: the CAM resized to the attention grid, the
PCM, the resize back), from the span's CUDA events, over the `step`
units the port's tracer recorded in the profiled part
(dram_tpu_torch.tracing). Nothing to read in a model without a PCM or
a program without the tracer."""


def read(ctx):
    if ctx["prof"] is None:
        return None
    try:
        from dram_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    units = {u["unit"] for u in snap["units"] if u["name"] == "step"}
    ms = [s["device_ms"] for s in snap["spans"]
          if s["name"] == "pcm" and s["unit"] in units]
    if not units or not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(units)
