"""The conv kernels' share of their roofline over the profiled steps:
the sum of the bounds of every forward (with statistics), input
gradient and weight gradient launch of a step (lib/convcount.py) over
the conv kernels' device time, the column sums that finish statistics
and split weight gradients included, %."""

from portbench.lib import convcount


def read(ctx):
    p = ctx["prof"]
    if p is None or ctx["traffic"]["kind"] != "train_step":
        return None
    cfg = ctx["config"]["values"]
    launches = convcount.train_launches(cfg["MODEL"],
                                        cfg["RESAMPLE_SIZE"][0])
    return convcount.roofline_share(p["device_ops"], launches,
                                    int(cfg["TRAIN_BATCH_SIZE"]),
                                    p["units"])
