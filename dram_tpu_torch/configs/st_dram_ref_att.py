"""st_dram_ref_att: the flagship DC3DATGeneric training settings.

The port's copy of what a training step reads from
dram_tpu/configs/st_dram_ref_att.py (the reference
exp_settings/st_dram_ref_att.py): the published DC3D widths and the
stencil-attention (`at_*`) settings, chunk size, batch, loss, optimizer,
scheduler, initializer, the wide -1000..-700 HU window, compute dtype and
seed. Method names resolve inside the port
(dram_tpu_torch.configs.get_callable_by_name).
"""

EXP_NAME = "st_dram_ref_rw"
MODEL_NAME = "DC3DATGeneric"

RESAMPLE_SIZE = (80, 80, 80)
TRAIN_BATCH_SIZE = 10
LOSS_FACTORS = [2.0, 1.0, 0.5, 0.5]

WINDOWING_MAX = -700
WINDOWING_MIN = -1000
NR_CLASS = 1

# bf16 activations on the card; parameters stay f32
COMPUTE_DTYPE = "bfloat16"
RANDOM_SEED = 33

MODEL = {
    "method": "models.DC3DATGeneric",
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
    "at_spatial_size": (64, 64, 64),
    "at_f_dim": 8,
    "at_g_dim": 8,
    "at_g_iter": 1,
    "at_k_size": 3,
    "at_merge_type": "scaled_dot_product_relu",
    "at_self_loop": False,
    "at_layers": [-1, 0, 1],
    "at_p_enc_dim": 0,
    "at_geo_f_dim": 0,
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
