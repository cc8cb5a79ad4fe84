"""Published peaks of one NVIDIA H100 (SXM, dense, 700 W) and the
roofline bound of a launch: a frozen copy of chip_smoke.py:317 and
:399-406."""

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes, flops, peak_flops=BF16_FLOPS):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate (seconds)."""
    return max(nbytes / HBM_BPS, flops / peak_flops)
