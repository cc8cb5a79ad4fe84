"""Full-scan inference CLI of the port:

    python3 -m dram_tpu_torch.process_pipeline --input DIR --lobes DIR \\
        --output DIR [--smp SETTINGS.py] [--ckp_path CKPT] [--shard N] \
        [--device cuda]

The flags of the JAX package's process_pipeline.py, and --device (default
cuda; pass cpu to run the plain versions on the host). --shard N sets
SHARD_SCANS: N scans in flight, one per local GPU ("auto" or -1: every
GPU; see infer/engine.py).
The default settings are the port's configs/st_dram_ref_att.py, whose
paths follow DRAM_DATA_ROOT and DRAM_OUTPUT_ROOT. Checkpoints come from
--ckp_path, else the newest one under the settings' MODEL_ROOT_PATH /
EXP_NAME. Default directories follow the grand-challenge layout.
"""

import os
from argparse import ArgumentParser

from dram_tpu_torch.infer.engine import LesionSegTest
from dram_tpu_torch.utils import Settings

DEFAULT_SETTINGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "st_dram_ref_att.py")


def run_testing_job(args):
    settings = Settings(args.smp or DEFAULT_SETTINGS)
    if args.ckp_path is not None:
        settings.RELOAD_CHECKPOINT_PATH = args.ckp_path
    settings.RELOAD_CHECKPOINT = True
    if args.shard:
        settings.SHARD_SCANS = -1 if args.shard in ("auto", "-1") \
            else int(args.shard)
    runner = LesionSegTest(settings_module=settings,
                           scan_path=args.input,
                           lobe_path=args.lobes,
                           output_path=args.output,
                           task_name=args.task_name,
                           device=args.device)
    return runner.run()


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--input", type=str, default="/input/images/ct/",
                        help="directory of CT .mha scans (deployment mode); "
                             "omit to use the settings' test split")
    parser.add_argument("--lobes", type=str,
                        default="/input/images/pulmonary-lobes/",
                        help="directory of lobe-segmentation .mha masks")
    parser.add_argument("--output", type=str, default="/output/images/",
                        help="output directory")
    parser.add_argument("--smp", type=str, default=None,
                        help="settings module path")
    parser.add_argument("--ckp_path", type=str, default=None,
                        help="checkpoint to load")
    parser.add_argument("--task_name", type=str, default="test")
    parser.add_argument("--shard", type=str, default=None,
                        help="scan-level parallelism: N scans in flight, "
                             "one per GPU ('auto'/'-1' = every local GPU)")
    parser.add_argument("--use_test_split", action="store_true",
                        help="score the settings' TEST_CSV split instead of "
                             "an input directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                             "versions)")
    args = parser.parse_args(argv)
    if args.use_test_split:
        args.input = None
        args.lobes = None
    run_testing_job(args)


if __name__ == "__main__":
    main()
