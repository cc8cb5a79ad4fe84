"""Training of the port: one step of st_dram_ref's DC3D or of the
flagship st_dram_ref_att's DC3DATGeneric, and an entry point that takes a
few."""

from .trainer import TrainStep, build_train_step, train_steps  # noqa: F401
