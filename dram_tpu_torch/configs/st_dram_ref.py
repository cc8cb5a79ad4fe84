"""st_dram_ref: DC3D (no attention) training settings.

The port's copy of what a training step reads from
dram_tpu/configs/st_dram_ref.py (the reference exp_settings/st_dram_ref.py):
the published DC3D widths, chunk size, batch, loss, optimizer, scheduler,
initializer, windowing, compute dtype and seed, and the epoch loop's
settings (epochs, validation and checkpoint cadence, loader threads,
augmentation ratio, balanced chunks per label, the training and
validation splits). Method names resolve inside the port
(dram_tpu_torch.configs.get_callable_by_name). The runner and inference
settings (paths under DRAM_DATA_ROOT and DRAM_OUTPUT_ROOT,
checkpoint reload, resampling, pad value, logging) are those of
dram_tpu/configs/st_dram_ref.py, which the inference engine reads.
"""

import os

_ROOT = os.environ.get("DRAM_DATA_ROOT", "./data")
_OUT = os.environ.get("DRAM_OUTPUT_ROOT", "./outputs")

RELOAD_CHECKPOINT = False
RELOAD_CHECKPOINT_PATH = None
RELOAD_DICT_LIST = ["model"]

DB_PATH = _ROOT
TEST_CSV = f"{_ROOT}/test.csv"
TRAIN_CSV = f"{_ROOT}/wss_train.csv"
VALID_CSV = f"{_ROOT}/val.csv"
DEBUG_PATH = f"{_OUT}/test_cases/"
MODEL_ROOT_PATH = f"{_OUT}/models/"

JOB_RUNNER_CLS = "job_runner.LesionSegChunkTrain"
TEST_JOB_RUNNER_CLS = "job_runner.LesionSegTest"

EXP_NAME = "st_dram_ref"
MODEL_NAME = "DC3D"

RESAMPLE_MODE = "fixed_size"

# the epoch loop (train/chunk_train.py)
NUM_EPOCHS = 200
VAL_EPOCHS = 10
STATE_EPOCHS = 10
NUM_WORKERS = 4
LOG_STEPS = 1
AUG_RATIO = 0.0
BALANCED_LABEL_COUNT = 200

RESAMPLE_SPACING = 1.0
TEST_RESAMPLE_SPACING = 1.0
RESAMPLE_SIZE = (80, 80, 80)
TRAIN_BATCH_SIZE = 10
LOSS_FACTORS = [2.0, 1.0, 0.5, 0.5]

PAD_VALUE = -2048
WINDOWING_MAX = -300
WINDOWING_MIN = -1000
NR_CLASS = 1

# bf16 activations on the card; parameters stay f32
COMPUTE_DTYPE = "bfloat16"
RANDOM_SEED = 33

MODEL = {
    "method": "models.DC3D",
    "n_layers": 3,
    "in_ch_list": [1, 64, 128, 256, 768, 384, 192],
    "base_ch_list": [32, 64, 128, 256, 256, 128, 64],
    "end_ch_list": [64, 128, 256, 512, 256, 128, 64],
    "kernel_sizes": [(3, 3)] * 7,
    "stacking": 3,
    "padding_list": [(1, 1)] * 7,
    "checkpoint_layers": [0, 0, 0, 0, 0, 0, 0],
    "dropout": 0.0,
    "upsample_ksize": (3, 3, 3),
    "upsample_sf": (2, 2, 2),
    "out_ch": NR_CLASS,
}

INITIALIZER = {
    "method": "models.HeNorm",
    "mode": "fan_in",
}

OPTIMIZER = {
    "method": "torch.optim.Adam",
    "lr": 0.0001,
}

SCHEDULER = {
    "method": "torch.optim.lr_scheduler.ExponentialLR",
    "gamma": 0.9,
}

LOSS_FUNC = {
    "method": "metrics.IntRegRefineLoss",
    "band_width": 1e-2,
    "smoothing": 0.1,
}


def _logging_config(filename):
    return {
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "standard": {
                "format": "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
            },
        },
        "handlers": {
            "console": {
                "level": "INFO",
                "formatter": "standard",
                "class": "logging.StreamHandler",
                "stream": "ext://sys.stdout",
            },
            "file_handler": {
                "class": "logging.handlers.RotatingFileHandler",
                "level": "INFO",
                "formatter": "standard",
                "filename": f"{MODEL_ROOT_PATH}/{EXP_NAME}/{filename}",
                "maxBytes": 10485760,
                "backupCount": 20,
                "encoding": "utf8",
            },
        },
        "loggers": {
            "": {"handlers": ["console", "file_handler"],
                 "level": "INFO", "propagate": True},
        },
    }


LOGGING = _logging_config("info.log")
