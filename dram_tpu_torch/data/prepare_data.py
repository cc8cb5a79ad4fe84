"""Lobe-chunk extraction and the synthetic dataset makers, with the CLI

    python3 -m dram_tpu_torch.data.prepare_data --synthetic DIR
    python3 -m dram_tpu_torch.data.prepare_data --db_path DIR

Port of dram_tpu/data/prepare_data.py: `extract_lobe_chunks` (:28) writes
the chunk layout the training dataset reads ({task}/images|lobes|
pseudo_vessels/<pid>_<study>-<lobe>.mha and memo.csv with uid, patientid,
study, ctss): each lobe's bounding box with a 5 mm border, the scan set to
-2048 HU outside the lobe. `make_synthetic_dataset` (:133) writes a whole
RadboudCOVID layout of synthetic scans (data/synth.py:synth_scan) with its
CSV splits and chunks; `make_synthetic_copd_dataset` (:184) the COPDGene
layout. The same seed gives the same files, byte for byte, as the JAX
package's makers: the same numpy draws, the same MHA writer.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..core.ops import find_crops_np
from .datasets import RadboudCOVID
from .io import write_mha
from .synth import synth_scan


def extract_lobe_chunks(db_path, uids=None, task_in="wss", task_out="wss_chunk",
                        crop_border=5, pad_value=-2048, logger=None):
    """Extract per-lobe chunks from the full-scan dataset into the chunk
    layout. Returns the number of chunks written."""
    ds = RadboudCOVID(db_path, uids or RadboudCOVID.get_series_uids(
        os.path.join(db_path, "wss_all.csv")), task=task_in,
        use_masked_scan=False)
    out_root = os.path.join(db_path, task_out)
    img_dir = os.path.join(out_root, "images")
    lobe_dir = os.path.join(out_root, "lobes")
    vessel_dir = os.path.join(out_root, "pseudo_vessels")
    for d in (img_dir, lobe_dir, vessel_dir):
        os.makedirs(d, exist_ok=True)

    rows = []
    for uid in ds.uids:
        sample = ds.get_data(uid)
        scan = sample["#image"]
        lobe = sample["#lobe_reference"]
        vessel = sample["#vessel_reference"]
        meta = sample["meta"]
        pid, sid = uid.split("_")
        patient_meta = meta["patient_meta"]
        geometry = dict(spacing=meta["spacing"], origin=meta["origin"],
                        direction=meta["direction"])
        for lobe_label in range(1, 6):
            lobe_binary = lobe == lobe_label
            if lobe_binary.sum() < 1:
                continue
            col = RadboudCOVID.metric_k_mapping[lobe_label]
            ctss = int(float(patient_meta.get(col, 0)))
            slices = find_crops_np(lobe_binary, meta["spacing"], crop_border)
            chunk = scan[slices].copy()
            lobe_chunk = lobe_binary[slices].astype(np.uint8)
            vessel_chunk = (vessel[slices] > 0).astype(np.uint8)
            chunk[lobe_chunk == 0] = pad_value
            chunk_uid = f"{uid}-{lobe_label}"
            write_mha(os.path.join(img_dir, f"{chunk_uid}.mha"),
                      chunk.astype(np.int16), **geometry)
            write_mha(os.path.join(lobe_dir, f"{chunk_uid}.mha"),
                      lobe_chunk, **geometry)
            write_mha(os.path.join(vessel_dir, f"{chunk_uid}.mha"),
                      vessel_chunk, **geometry)
            rows.append({"uid": chunk_uid, "patientid": pid, "study": sid,
                         "ctss": ctss})
        if logger:
            logger.info(f"extracted chunks for {uid}")

    with open(os.path.join(out_root, "memo.csv"), "wt", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=["uid", "patientid", "study", "ctss"])
        w.writeheader()
        w.writerows(rows)
    return len(rows)


def _write_csv(path, rows, fieldnames):
    with open(path, "wt", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)


def make_synthetic_dataset(db_path, n_scans=4, size=(48, 64, 64), seed=0,
                           task="wss"):
    """The RadboudCOVID layout with synthetic scans at 1.5 x 0.8 x 0.8 mm:
    {task}/{images,lobes,lesion,pseudo_vessels}/, wss_all.csv and the
    wss_train.csv / val.csv / test.csv splits (the last quarter of the
    scans, at least one, validates and tests), then the lobe chunks.
    Returns {"uids", "n_chunks"}."""
    rng = np.random.default_rng(seed)
    dirs = {d: os.path.join(db_path, task, d)
            for d in ("images", "lobes", "lesion", "pseudo_vessels")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    fieldnames = ["patientid", "study", "lul [0-5]", "lll [0-5]",
                  "rul [0-5]", "rll [0-5]", "rml [0-5]", "cle"]
    rows = []
    uids = []
    for i in range(n_scans):
        pid, sid = f"p{i:03d}", "s1"
        uid = f"{pid}_{sid}"
        uids.append(uid)
        scan, lobe, lesion, vessel, sev = synth_scan(rng, size)
        spacing = (1.5, 0.8, 0.8)
        for name, arr in (("images", scan), ("lobes", lobe),
                          ("lesion", lesion), ("pseudo_vessels", vessel)):
            write_mha(os.path.join(dirs[name], f"{uid}.mha"), arr,
                      spacing=spacing)
        row = {"patientid": pid, "study": sid, "cle": int(max(sev))}
        for lobe_label, col in RadboudCOVID.metric_k_mapping.items():
            row[col] = sev[lobe_label - 1]
        rows.append(row)

    _write_csv(os.path.join(db_path, "wss_all.csv"), rows, fieldnames)
    n_val = max(1, n_scans // 4)
    splits = {"wss_train.csv": rows[:-n_val] or rows,
              "val.csv": rows[-n_val:],
              "test.csv": rows[-n_val:]}
    for fname, subset in splits.items():
        _write_csv(os.path.join(db_path, fname), subset, fieldnames)

    n_chunks = extract_lobe_chunks(db_path, task_in=task)
    return {"uids": uids, "n_chunks": n_chunks}


def make_synthetic_copd_dataset(db_path, n_scans=4, size=(48, 64, 64),
                                seed=0, emphysema_th=-950):
    """The COPDGene layout: full scans at db_path/*.mha, lobes under
    derived/seg-lobes-copdgene-approved_Lobes/mha/, meta/ctss.csv with
    CLE / PSE severities, the lobe chunks (images/, lobes/, lesions/ and
    memo.csv with uid, cle; lesion = voxels under `emphysema_th` HU in the
    lung) and the val.csv / test.csv splits. Returns {"n_scans",
    "n_chunks"}."""
    rng = np.random.default_rng(seed)
    lobe_dir = os.path.join(db_path,
                            "derived/seg-lobes-copdgene-approved_Lobes/mha")
    meta_dir = os.path.join(db_path, "meta")
    chunk_dirs = {d: os.path.join(db_path, d)
                  for d in ("images", "lobes", "lesions")}
    for d in [lobe_dir, meta_dir, *chunk_dirs.values()]:
        os.makedirs(d, exist_ok=True)

    ctss_rows, memo_rows = [], []
    spacing = (1.5, 0.8, 0.8)
    for i in range(n_scans):
        uid = f"copd{i:03d}"
        scan, lobe, lesion, vessel, sev = synth_scan(rng, size)
        # emphysema: low-HU pockets where the lesions were
        scan = scan.copy()
        scan[lesion > 0] = emphysema_th - 50
        write_mha(os.path.join(db_path, f"{uid}.mha"), scan, spacing=spacing)
        write_mha(os.path.join(lobe_dir, f"{uid}.mha"), lobe, spacing=spacing)
        ctss_rows.append({"SeriesInstanceUID": uid,
                          "CT_Visual_Emph_Severity_P1": int(max(sev)),
                          "CT_Visual_Emph_Paraseptal_P1": int(min(sev))})
        es = np.logical_and(scan < emphysema_th, lobe > 0).astype(np.uint8)
        for li in range(1, 6):
            m = lobe == li
            if not m.any():
                continue
            sl = find_crops_np(m, spacing, 5)
            chunk_uid = f"{uid}-{li}"
            chunk = scan[sl].copy()
            chunk[~m[sl]] = -2048
            write_mha(os.path.join(chunk_dirs["images"], f"{chunk_uid}.mha"),
                      chunk.astype(np.int16), spacing=spacing)
            write_mha(os.path.join(chunk_dirs["lobes"], f"{chunk_uid}.mha"),
                      m[sl].astype(np.uint8), spacing=spacing)
            write_mha(os.path.join(chunk_dirs["lesions"], f"{chunk_uid}.mha"),
                      es[sl].astype(np.uint8), spacing=spacing)
            memo_rows.append({"uid": chunk_uid, "cle": sev[li - 1]})

    ctss_fields = list(ctss_rows[0].keys())
    _write_csv(os.path.join(meta_dir, "ctss.csv"), ctss_rows, ctss_fields)
    _write_csv(os.path.join(db_path, "memo.csv"), memo_rows, ["uid", "cle"])
    for fname in ("val.csv", "test.csv"):
        _write_csv(os.path.join(db_path, fname),
                   ctss_rows[-max(1, n_scans // 4):], ctss_fields)
    return {"n_scans": n_scans, "n_chunks": len(memo_rows)}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Lobe-chunk extraction")
    p.add_argument("--db_path", type=str, default=None,
                   help="dataset root (contains wss/ and wss_all.csv)")
    p.add_argument("--synthetic", type=str, default=None,
                   help="create a synthetic dataset at this path instead")
    p.add_argument("--n_scans", type=int, default=4)
    p.add_argument("--size", type=int, nargs=3, default=(48, 64, 64))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.synthetic:
        info = make_synthetic_dataset(args.synthetic, args.n_scans,
                                      tuple(args.size), args.seed)
        print(f"synthetic dataset at {args.synthetic}: "
              f"{len(info['uids'])} scans, {info['n_chunks']} chunks")
    elif args.db_path:
        n = extract_lobe_chunks(args.db_path)
        print(f"extracted {n} lobe chunks under {args.db_path}/wss_chunk")
    else:
        p.error("need --db_path or --synthetic")


if __name__ == "__main__":
    main()
