#!/usr/bin/env python3
"""Readings of chip_smoke.py's `train val paths` gate for the sound
validation epilogue and for deliberately broken copies of it, on one
NVIDIA GPU.

    python3 tools/val_gate_mutants.py [--variants a,b]

For each variant the script copies dram_tpu_torch/ and chip_smoke.py
into a temporary directory, changes one line of
FastScanPipeline.process_chunks_val there (the checkout is never
changed) and, in the copy, makes chip_smoke's epoch dataset, builds a
LesionSegChunkTrain of the flagship settings from the trained tree
(assets/bench_weights.ckpt.xz) and prints each validation scan's ratio
by the fast path (the chunk wire's prep and process_chunks_val) and by
the host-stitch loop (batch-1 forwards), their relative difference and
labels: where the gate's limit (chip_smoke.VAL_RATIO_RTOL) sits.
Variants:

- sound: the tree as it is;
- no_present: the epilogue's mask is the lobe masks alone, without the
  prep's per-lobe `present` flags;
- no_lung_mask: the mask is `present` alone, over the whole bucket;
- no_sigmoid: the epilogue sums the refined head's logits, not its
  probabilities.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from kernel_copies import card_line, make_copy, run_in_copy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = "infer/fast.py"
MASK = ('''        m = lmask.float() * self._put(np.asarray(
            prepc["present"], np.float32))[:, None, None, None]''')
VARIANTS = {
    "sound": None,
    "no_present": (FAST, MASK, "        m = lmask.float()"),
    "no_lung_mask": (FAST, MASK, '''        m = torch.ones_like(lmask, dtype=torch.float32) * self._put(
            np.asarray(prepc["present"], np.float32))[:, None, None, None]'''),
    "no_sigmoid": (FAST, "probs = gather_resize(torch.sigmoid(out), ",
                   "probs = gather_resize(out, "),
}
LIMIT_S = 300


def read(bench):
    """Run in a copy's directory: the gate's readings of that copy."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dram_tpu_torch import weights
    from dram_tpu_torch.train.chunk_train import LesionSegChunkTrain
    from dram_tpu_torch.utils import Settings
    with tempfile.TemporaryDirectory() as root:
        db = f"{root}/db"
        cs.make_synthetic_dataset(db, n_scans=cs.EPOCH_SCANS,
                                  size=cs.SCAN_SHAPE, seed=cs.SEED)
        params, batch_stats = weights.load_bench_weights(bench)
        trained = f"{root}/trained.ckpt"
        cs.save_checkpoint(trained, {"model": {"params": params,
                                               "batch_stats": batch_stats}})
        s = Settings(cs.epoch_settings(root, db, cs.epoch_label_count(db)))
        s.RELOAD_CHECKPOINT, s.RELOAD_CHECKPOINT_PATH = True, trained
        runner = LesionSegChunkTrain(s, device="cuda")
        for uid, fr, hr, fl, hl, target in cs.val_path_readings(runner):
            rel = abs(fr - hr) / max(abs(hr), 1e-12)
            print("# reading " + json.dumps({
                "uid": uid, "fast_ratio": fr, "hoststitch_ratio": hr,
                "relative_difference": rel, "fast_label": int(fl),
                "hoststitch_label": int(hl), "target": int(target),
                "limit": cs.VAL_RATIO_RTOL,
                "gate": "pass" if fl == hl and rel <= cs.VAL_RATIO_RTOL
                else "fail"}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", help="comma-separated names to read "
                    "(default: all)")
    args = ap.parse_args()
    variants = VARIANTS
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(variants)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}")
        variants = {k: variants[k] for k in names}
    print(card_line(), flush=True)
    bench = os.path.join(ROOT, "assets", "bench_weights.ckpt.xz")
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, change in variants.items():
            d = make_copy(tmp, name, [change] if change is not None else [])
            print(f"# variant {name}: "
                  f"{'as in the tree' if change is None else change[2]}",
                  flush=True)
            rc = run_in_copy(d, __file__, ["--read", bench], LIMIT_S)
            if rc != 0:
                print(f"# variant {name} exited {rc}", flush=True)
                failed.append(name)
    if failed:
        raise SystemExit(f"variants that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2])
    else:
        main()
