"""st_dram_ref: DC3D (no attention) training settings.

The port's copy of what a training step reads from
dram_tpu/configs/st_dram_ref.py (the reference exp_settings/st_dram_ref.py):
the published DC3D widths, chunk size, batch, loss, optimizer, scheduler,
initializer, windowing, compute dtype and seed. Method names resolve
inside the port (dram_tpu_torch.configs.get_callable_by_name).
"""

EXP_NAME = "st_dram_ref"
MODEL_NAME = "DC3D"

RESAMPLE_SIZE = (80, 80, 80)
TRAIN_BATCH_SIZE = 10
LOSS_FACTORS = [2.0, 1.0, 0.5, 0.5]

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
