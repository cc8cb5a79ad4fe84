"""Training losses of the port (dram_tpu/losses): the interval-regression
loss and its refinement variant, the configured loss of st_dram_ref."""

from .bootstrap_bce import BinaryCrossEntropySmooth, BootBinCrossEntropy  # noqa: F401
from .interval_reg import CTSS_RATIO_LB, CTSS_RATIO_UB, IntRegLoss  # noqa: F401
from .refine import IntRegRefineLoss  # noqa: F401
