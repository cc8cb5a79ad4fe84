"""A cell cut to a size a CPU test holds: narrow widths, 16^3 chunks,
float32, parameters from the seed, two small scans; limits set from
such runs' sound readings (float32 on both sides read 0 to 3e-5), far
under what the faults and the control read."""

import copy

from portbench.lib import harness

TINY_LIMITS = {"train_step": {"loss_gap": 1e-3, "grad_gap": 1e-2,
                              "grad_cos_gap": 1e-3, "change_gap": 1e-2},
               "scan_infer": {"pred_diff": 1e-3, "post_diff": 1e-3,
                              "ratio_gap": 1e-3}}


def tiny(workload):
    _, cfg, traffic, _ = harness.cell(workload)
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
    if traffic["kind"] == "scan_infer":
        traffic["geometries"] = [[[40, 48, 48], [1.0, 0.8, 0.8]],
                                 [[44, 40, 40], [0.9, 1.0, 1.0]]]
    return {"config": cfg, "traffic": traffic,
            "limits": dict(TINY_LIMITS[traffic["kind"]])}
