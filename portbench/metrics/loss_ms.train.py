"""Device ms a step in the loss's own work: the program's `loss` span
less the `model` spans inside it (TrainStep: the losses' elementwise
passes, reductions and resizes, the model's forward left out), from the
spans' CUDA events, over the `step` units the port's tracer recorded in
the profiled part (dram_tpu_torch.tracing). Nothing to read in a
program without the tracer."""


def read(ctx):
    if ctx["prof"] is None:
        return None
    try:
        from dram_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    units = {u["unit"] for u in snap["units"] if u["name"] == "step"}
    loss = {s["id"]: s for s in snap["spans"]
            if s["name"] == "loss" and s["unit"] in units}
    model = [s for s in snap["spans"]
             if s["name"] == "model" and s["parent"] in loss]
    ms = [s["device_ms"] for s in list(loss.values()) + model]
    if not units or not loss or any(m is None for m in ms):
        return None
    return (sum(s["device_ms"] for s in loss.values())
            - sum(s["device_ms"] for s in model)) / len(units)
