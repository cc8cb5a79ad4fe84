#!/usr/bin/env python3
"""Make the flagship mask golden that chip_smoke.py holds the port against.

    python3 tools/make_port_golden.py               # write the golden
    python3 tools/make_port_golden.py --time-chunk  # time one 80^3 chunk

Runs the JAX package's FastScanPipeline.process_chunks on the CPU over
chip_smoke.py's scan (data/synth.py:synth_scan at SCAN_SHAPE, SPACING,
SEVERITIES, seed SEED, window WINDOW), prepped by the port's own
prep_scan_chunks, with the flagship DC3DATGeneric in bf16 and the trained
weights (assets/bench_weights.ckpt.xz), for want_heatmap False. On the CPU
the JAX package runs its defaults use_fused_stack = use_pallas_conv =
use_pallas_attention = False: the unfused stack with XLA convs, which
compute the same functions as the Pallas conv and attention kernels.

Writes dram_tpu_torch/golden/flagship_scan.npz (compressed): the bit-packed
pred and post masks, the Otsu threshold and its bin, the per-lobe ratios,
the scan shape, the SHA-256 of the drawn scan (scan, lobe and vessel
arrays), of the prepped chunk bits (x80_bits) and of the lobe bits, and
the chunks' 8^3 block means, so that chip_smoke.py sees another draw or
another prep before it compares masks. This tool imports the JAX package;
dram_tpu_torch and chip_smoke.py do not.
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dram_tpu_torch.data.synth import synth_scan  # noqa: E402
from dram_tpu_torch.infer.fast import prep_scan_chunks  # noqa: E402

GOLDEN = os.path.join(ROOT, *chip_smoke.GOLDEN.split("/"))


def scan_prep():
    """(draw, prepc): chip_smoke.py's scan (scan, lobe, vessel) and the
    port's prep of it."""
    scan, lobe, _, vessel, _ = synth_scan(
        np.random.default_rng(chip_smoke.SEED), chip_smoke.SCAN_SHAPE,
        lesion_severity=chip_smoke.SEVERITIES)
    return (scan, lobe, vessel), prep_scan_chunks(
        scan, lobe, chip_smoke.SPACING, vessel_u8=vessel,
        windowing_span=chip_smoke.WINDOW)


def pipeline():
    sys.path.insert(0, ROOT)
    import bench
    from dram_tpu.infer.fast import FastScanPipeline
    from dram_tpu.models import DC3DATGeneric
    v = bench.load_bench_weights()
    if v is None:
        raise SystemExit("assets/bench_weights.ckpt.xz could not be read")
    model = DC3DATGeneric(train=False, at_spatial_size=(64, 64, 64),
                          dtype=jnp.bfloat16)
    return model, v, FastScanPipeline(model, v["params"], v["batch_stats"],
                                      chunk_size=(80, 80, 80),
                                      windowing_span=chip_smoke.WINDOW)


def time_chunk():
    model, v, _ = pipeline()
    x = jnp.zeros((1, 80, 80, 80, 1), jnp.float32)
    fwd = jax.jit(lambda p, b, x: model.apply(
        {"params": p, "batch_stats": b}, x, x))
    t0 = time.perf_counter()
    jax.block_until_ready(fwd(v["params"], v["batch_stats"], x))
    t1 = time.perf_counter()
    jax.block_until_ready(fwd(v["params"], v["batch_stats"], x))
    t2 = time.perf_counter()
    print(f"one 80^3 chunk on {os.cpu_count()} CPU cores: first call "
          f"{t1 - t0:.1f} s (compile included), second {t2 - t1:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-chunk", action="store_true",
                    help="time the model on one 80^3 chunk and exit")
    args = ap.parse_args()
    if args.time_chunk:
        time_chunk()
        return
    t0 = time.perf_counter()
    draw, prepc = scan_prep()
    _, _, pipe = pipeline()
    t1 = time.perf_counter()
    out = pipe.process_chunks(dict(prepc), want_heatmap=False)
    t2 = time.perf_counter()
    pred, post = np.asarray(out["pred"]) > 0, np.asarray(out["post"]) > 0
    th = float(out["threshold"])
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(
        GOLDEN, pred_bits=np.packbits(pred), post_bits=np.packbits(post),
        threshold=np.float32(th), otsu_bin=np.int32(round(th * 255)),
        ratios=np.asarray(out["ratios"], np.float32),
        scan_shape=np.asarray(pred.shape, np.int32),
        draw_sha256=np.array(chip_smoke.sha256(*draw)),
        x80_sha256=np.array(chip_smoke.sha256(prepc["x80_bits"])),
        lobe_sha256=np.array(chip_smoke.sha256(prepc["lobe_bits"])),
        x80_block_means=chip_smoke.block_means(prepc["x80_bits"]),
        jax_version=np.array(jax.__version__),
        numpy_blas=np.array(chip_smoke.numpy_blas()))
    print(f"wrote {os.path.relpath(GOLDEN, ROOT)} "
          f"({os.path.getsize(GOLDEN)} bytes): threshold {th:.6f} (bin "
          f"{round(th * 255)}), pred voxels {int(pred.sum())}, post voxels "
          f"{int(post.sum())}, ratios {np.asarray(out['ratios']).tolist()}; "
          f"prep and set-up {t1 - t0:.1f} s, process_chunks {t2 - t1:.1f} s "
          f"on {os.cpu_count()} CPU cores (jax {jax.__version__})")


if __name__ == "__main__":
    main()
