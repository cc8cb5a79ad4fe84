"""A cell cut to a size a CPU test holds: narrow widths, 16^3 chunks,
float32, parameters from the seed, two small scans; limits set from
such runs' sound readings, far under what the faults and the control
read. Training: float32 on both sides reads 0 to 3e-5. Scans: the
masks differ by a few voxels at the Otsu cut (the program's C++ prep
rounds HU where the reference's prep does not): pred_diff / post_diff
read 0 to 0.0078 over eighteen seeds, eight of them with non-empty
masks (0.0078 is 2 of 290 mask voxels), against 0.089 and more for the
faults and the control on five of those; ratio_gap reads at most
1.3e-5."""

import copy

from portbench.lib import harness

# by the driver's family; a cell takes the limits its committed file
# names
TINY_LIMITS = {"train": {"loss_gap": 1e-3, "grad_gap": 1e-2,
                         "grad_cos_gap": 1e-3, "change_gap": 1e-2},
               "scan": {"pred_diff": 0.025, "post_diff": 0.025,
                        "ratio_gap": 1e-3, "label_err": 0.0}}


def tiny(workload):
    _, cfg, traffic, limits = harness.cell(workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    v = cfg["values"]
    v["MODEL"].update(base_ch_list=[4, 8, 8, 8, 8, 8, 8],
                      end_ch_list=[8, 8, 8, 16, 8, 8, 8],
                      in_ch_list=[1, 8, 8, 8, 24, 16, 16])
    if "at_spatial_size" in v["MODEL"]:
        v["MODEL"]["at_spatial_size"] = [12, 12, 12]
    v["RESAMPLE_SIZE"] = [16, 16, 16]
    v["TRAIN_BATCH_SIZE"] = 4
    v["COMPUTE_DTYPE"] = "float32"
    cfg["weights"] = "seed"
    family = harness.family(traffic)
    if family == "scan":
        traffic["geometries"] = [[[40, 48, 48], [1.0, 0.8, 0.8]],
                                 [[44, 40, 40], [0.9, 1.0, 1.0]]]
    return {"config": cfg, "traffic": traffic,
            "limits": {k: TINY_LIMITS[family][k] for k in limits}}
