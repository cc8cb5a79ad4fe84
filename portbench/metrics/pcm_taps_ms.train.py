"""Device ms a step in the taps and the PCM: the kernels launched inside
the tap heads' and the attention module's forwards (ranges the harness
opens around them) and by the backward of the operations recorded
there (matched by autograd's sequence numbers), over the profiled
steps. Nothing to read in a model without a PCM."""


def read(ctx):
    p = ctx["prof"]
    if p is None or p["pcm_taps_us"] is None or not p["units"]:
        return None
    return p["pcm_taps_us"] / 1e3 / p["units"]
