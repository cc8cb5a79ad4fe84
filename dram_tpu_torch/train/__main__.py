"""Training CLI of the port:

    python3 -m dram_tpu_torch.train [PRETRAIN] [LR] [--batch_size N] \\
        [--smp SETTINGS.py] [--ckp_path CKPT] [--device cuda]

Data parallel on one host with N GPUs (or N CPU processes with
--device cpu):

    torchrun --nproc-per-node N -m dram_tpu_torch.train [...]

Each rank joins torchrun's process group (core/mesh.py) and takes
cuda:LOCAL_RANK (ranks that outnumber the GPUs share them, over gloo)
or the CPU; without torchrun nothing changes.

The surface of the JAX package's train.py: positional `pretrain` (reload
a checkpoint when > 0) and `lr`, --batch_size, --smp and --ckp_path, each
overriding the loaded settings, and --device (default cuda; pass cpu to
run the plain versions on the host). The default settings are the port's
configs/st_dram_ref.py, whose paths follow DRAM_DATA_ROOT and
DRAM_OUTPUT_ROOT. The settings' JOB_RUNNER_CLS runs (the epoch loop,
train/chunk_train.py).
"""

import os
from argparse import ArgumentParser

from dram_tpu_torch import require_cuda
from dram_tpu_torch.configs import get_callable_by_name
from dram_tpu_torch.core.mesh import local_device, maybe_init_distributed
from dram_tpu_torch.utils import Settings

DEFAULT_SETTINGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "st_dram_ref.py")


def run_training_job(args):
    """Build the runner of the settings with the CLI's overrides, run its
    epochs and return it."""
    settings = Settings(args.smp or DEFAULT_SETTINGS)
    settings.OPTIMIZER = dict(settings.OPTIMIZER, lr=args.lr)
    settings.RELOAD_CHECKPOINT_PATH = args.ckp_path
    settings.RELOAD_CHECKPOINT = args.pretrain > 0
    settings.TRAIN_BATCH_SIZE = args.batch_size
    runner_cls = get_callable_by_name(settings.JOB_RUNNER_CLS)
    device = args.device
    kind = device.split(":")[0]
    if kind == "cuda":
        # a CUDA request without a GPU raises here, before any group forms
        require_cuda(device)
    if maybe_init_distributed(kind):
        device = local_device(kind)
    runner = runner_cls(settings, device=device)
    runner.run()
    return runner


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("pretrain", type=int, nargs="?", default=0,
                        help="reload from checkpoint if > 0")
    parser.add_argument("lr", type=float, nargs="?", default=0.001,
                        help="learning rate")
    parser.add_argument("--batch_size", type=int, nargs="?", default=1,
                        help="training batch size")
    parser.add_argument("--smp", type=str, nargs="?", default=None,
                        help="settings module path")
    parser.add_argument("--ckp_path", type=str, default=None,
                        help="checkpoint path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                             "versions)")
    return run_training_job(parser.parse_args(argv))


if __name__ == "__main__":
    main()
