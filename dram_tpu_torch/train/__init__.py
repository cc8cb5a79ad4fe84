"""Training of the port: one step of st_dram_ref's DC3D or of the
flagship st_dram_ref_att's DC3DATGeneric and an entry point that takes a
few (trainer.py), the runner and its checkpoints (runner.py,
checkpoint.py), the epoch loop (chunk_train.py), the CLI
(`python3 -m dram_tpu_torch.train`) and the import of reference torch
checkpoints (torch_import.py)."""

from .trainer import TrainStep, build_train_step, train_steps  # noqa: F401
