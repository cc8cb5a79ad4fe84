"""The model's FLOPs a chunk through a training step (3 x the forward's
conv stacks, less the entry conv's input gradient) times the profiled
steps' chunks, over the device time those steps span in the trace (the
first operation's start to the last one's end, idle gaps included),
over the card's bf16 peak, %."""

from portbench.lib import convcount, harness, peaks


def read(ctx):
    p = ctx["prof"]
    if p is None or harness.family(ctx["traffic"]) != "train" or \
            not p["units"] or p["span_s"] <= 0:
        return None
    cfg = ctx["config"]["values"]
    if cfg["MODEL"]["method"] not in convcount.METHODS:
        return None
    flops = convcount.train_flops(cfg["MODEL"], cfg["RESAMPLE_SIZE"][0]) \
        * p["units"] * int(cfg["TRAIN_BATCH_SIZE"])
    return 100.0 * flops / p["span_s"] / peaks.BF16_FLOPS
