"""Datasets over the `#key` / meta sample-dict contract.

Port of dram_tpu/data/datasets.py on the port's MHA codec: `Dataset`
(:28), `_read_volume` (:38), `COPDGeneSubtypingLobeChunk` (:43; COPDGene
lobe chunks with their CLE scores), `COPDGeneSubtyping` (:91; the
emphysema-subtyping full scans), `TestDataset` (:149; bare scan + lobe
pairs for deployment), `RadboudCOVID` (:194; the scored full scans) and
`RadboudCOVIDLobeVesselChunk` (:297; the training lobe chunks, with
pseudo-lesion candidates computed on the fly).
"""

from __future__ import annotations

import glob
import os
import random
import shutil
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..core.ops import binary_cam_np, find_crops_np, windowing_np
from ..utils import read_csv_in_dict, read_csv_in_dict_double
from .io import read_mha


class Dataset:
    """Minimal map-style dataset protocol."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


def _read_volume(path):
    d = read_mha(path)
    return d["array"], d["origin"], d["spacing"], d["direction"]


class COPDGeneSubtypingLobeChunk(Dataset):
    """COPDGene lobe chunks: `images/`, `lobes/`, `lesions/<uid>.mha` with
    memo.csv keyed by `uid` (`<series>-<lobe>`) holding each chunk's CLE
    score."""

    ON_PREMISE_ROOT = None

    @classmethod
    def get_series_uids(cls, csv_file):
        scan_selected, _ = read_csv_in_dict(csv_file, "uid")
        return sorted(scan_selected.keys())

    @classmethod
    def get_series_uids_unique_scans(cls, csv_file):
        """One chunk uid per scan, its lobe drawn by the global `random`."""
        metas, _ = read_csv_in_dict(csv_file, "uid")
        scan_lobe_map = defaultdict(list)
        for lobe_wise_uid in metas.keys():
            scan_lobe_map[lobe_wise_uid[:-2]].append(lobe_wise_uid[-1])
        selected = [f"{uid}-{random.sample(scan_lobe_map[uid], 1)[0]}"
                    for uid in scan_lobe_map]
        return sorted(selected)

    def __init__(self, archive_path, uids, keep_sorted=True, transforms=None):
        self.archive_path = archive_path
        self.meta, _ = read_csv_in_dict(archive_path + "/memo.csv", "uid")
        self.uids = sorted(uids) if keep_sorted else list(uids)
        self.transforms = transforms

    def __len__(self):
        return len(self.uids)

    def __getitem__(self, index):
        return self.get_data(self.uids[index])

    def get_data(self, uid):
        scan, origin, spacing, direction = _read_volume(
            os.path.join(self.archive_path, "images", f"{uid}.mha"))
        lobe, *_ = _read_volume(
            os.path.join(self.archive_path, "lobes", f"{uid}.mha"))
        lesion, *_ = _read_volume(
            os.path.join(self.archive_path, "lesions", f"{uid}.mha"))
        base = dict(self.meta[uid])
        base.update({"size": scan.shape, "spacing": spacing,
                     "original_spacing": spacing, "original_size": scan.shape,
                     "origin": origin, "direction": direction})
        ret = {"#image": scan.astype(np.int16),
               "#lobe_reference": lobe.astype(np.uint8),
               "#lesion_reference": lesion.astype(np.uint8),
               "meta": base}
        return self.transforms(ret) if self.transforms else ret


class COPDGeneSubtyping(Dataset):
    """COPDGene emphysema subtyping on full scans: the lesion reference is
    the lung's voxels under `emphysema_th` HU, cropped to the lung's
    bounding box with a `crop_border` mm border; meta holds the scan's CLE
    and PSE scores (meta/ctss.csv)."""

    ON_PREMISE_ROOT = None

    @classmethod
    def get_series_uids(cls, csv_file):
        scan_selected, _ = read_csv_in_dict(csv_file, "SeriesInstanceUID")
        return sorted(scan_selected.keys())

    def __init__(self, archive_path, series_uids, transforms=None,
                 keep_sorted=True, crop_border=5, emphysema_th=-950):
        self.archive_path = archive_path
        self.transforms = transforms
        self.emphysema_th = emphysema_th
        self.lobe_path = archive_path + \
            "/derived/seg-lobes-copdgene-approved_Lobes/mha/"
        self.meta, _ = read_csv_in_dict(archive_path + "/meta/ctss.csv",
                                        "SeriesInstanceUID")
        self.crop_border = crop_border
        self.series_uids = sorted(series_uids) if keep_sorted \
            else random.sample(list(series_uids), len(series_uids))
        self.subtyping_labels = {
            uid: {"cle": int(float(
                      self.meta[uid]["CT_Visual_Emph_Severity_P1"])),
                  "pse": int(float(
                      self.meta[uid]["CT_Visual_Emph_Paraseptal_P1"]))}
            for uid in series_uids}

    def __len__(self):
        return len(self.series_uids)

    def __getitem__(self, index):
        return self.get_data(self.series_uids[index])

    def get_data(self, uid):
        scan, origin, spacing, direction = _read_volume(
            os.path.join(self.archive_path, f"{uid}.mha"))
        original_size = scan.shape
        lobe, *_ = _read_volume(self.lobe_path + f"/{uid}.mha")
        if lobe.shape != scan.shape:
            raise ValueError(f"{uid}: lobe mask {lobe.shape} does not match "
                             f"the scan {scan.shape}")
        lung = lobe > 0
        slices = find_crops_np(lung, spacing, self.crop_border)
        scan = scan[slices]
        lung = lung[slices].astype(np.uint8)
        lobe = lobe[slices].astype(np.uint8)
        es = np.logical_and(scan < self.emphysema_th,
                            lung > 0).astype(np.uint8)
        base = {"uid": uid, "size": scan.shape, "spacing": spacing,
                "crop_slices": slices, "LAA": self.emphysema_th,
                "original_spacing": spacing, "original_size": original_size,
                "origin": origin, "direction": direction,
                "cle": self.subtyping_labels[uid]["cle"],
                "pse": self.subtyping_labels[uid]["pse"]}
        ret = {"#image": scan.astype(np.int16),
               "#lobe_reference": lobe,
               "#lesion_reference": es,
               "meta": base}
        return self.transforms(ret) if self.transforms else ret


class TestDataset(Dataset):
    """Bare scan + lobe pairs for deployment: every `.mha` / `.mhd` scan of
    `scan_path` with the lobe mask of the same name under `lobe_path`."""

    __test__ = False  # not a pytest test class

    def __init__(self, scan_path, lobe_path, transforms=None, keep_sorted=True,
                 crop_border=5):
        self.scan_path = scan_path
        self.lobe_path = lobe_path
        self.crop_border = crop_border
        self.transforms = transforms
        scans = glob.glob(os.path.join(scan_path, "*.mha")) + \
            glob.glob(os.path.join(scan_path, "*.mhd"))
        uids = [Path(s).stem for s in scans]
        self.series_uids = sorted(uids) if keep_sorted else uids
        self.uids = self.series_uids  # the engine's name

    def __len__(self):
        return len(self.series_uids)

    def __getitem__(self, index):
        return self.get_data(self.series_uids[index])

    @staticmethod
    def _volume_path(folder, uid):
        """uid -> file path in either ITK MetaImage layout (single-file
        .mha, or .mhd header + external raw)."""
        for ext in (".mha", ".mhd"):
            p = os.path.join(folder, uid + ext)
            if os.path.exists(p):
                return p
        return os.path.join(folder, uid + ".mha")

    def get_data(self, uid):
        scan, origin, spacing, direction = _read_volume(
            self._volume_path(self.scan_path, uid))
        lobe, *_ = _read_volume(self._volume_path(self.lobe_path, uid))
        if lobe.shape != scan.shape:
            raise ValueError(f"{uid}: lobe mask {lobe.shape} does not match "
                             f"the scan {scan.shape}")
        base = {"uid": uid, "size": scan.shape, "spacing": spacing,
                "original_spacing": spacing, "original_size": scan.shape,
                "origin": origin, "direction": direction}
        ret = {"#image": scan.astype(np.int16),
               "#lobe_reference": lobe.astype(np.uint8),
               "meta": base}
        return self.transforms(ret) if self.transforms else ret


class RadboudCOVID(Dataset):
    """Full-scan COVID dataset: `<task>/{images,lobes,lesion,
    pseudo_vessels}/<pid>_<study>.mha` with per-lobe CT severity scores in
    `wss_all.csv`. The scan is masked to -2048 HU outside the lobes; a
    missing lesion or vessel mask reads as zeros."""

    ON_PREMISE_ROOT = None

    ctss_cut_off = {
        (0.0, 0.01): 0, (0.01, 0.05): 1, (0.05, 0.25): 2,
        (0.25, 0.5): 3, (0.5, 0.75): 4, (0.75, 1.00001): 5,
    }
    metric_k_mapping = {1: "lul [0-5]", 2: "lll [0-5]", 3: "rul [0-5]",
                        4: "rll [0-5]", 5: "rml [0-5]"}

    @classmethod
    def get_series_uids(cls, csv_file):
        scan_selected, _ = read_csv_in_dict_double(csv_file,
                                                   ["patientid", "study"])
        return sorted(f"{pid}_{sid}" for pid, sid in scan_selected.keys())

    def __init__(self, archive_path, uids, transforms=None, keep_sorted=True,
                 use_masked_scan=True, crop_border=5, task="wss"):
        self.transforms = transforms
        self.archive_path = archive_path
        self.crop_border = crop_border
        self.use_masked_scan = use_masked_scan
        self.lobe_folder = os.path.join(archive_path, task, "lobes")
        self.pseudo_vessel_folder = os.path.join(archive_path, task,
                                                 "pseudo_vessels")
        self.lesion_folder = os.path.join(archive_path, task, "lesion")
        self.scan_folder = os.path.join(archive_path, task, "images")
        self.all_metas, _ = read_csv_in_dict_double(
            os.path.join(archive_path, "wss_all.csv"), ["patientid", "study"])
        self.uids = sorted(uids) if keep_sorted \
            else random.sample(list(uids), len(uids))

        self.scan_path_map = self._path_map(self.scan_folder)
        self.lobe_path_map = self._path_map(self.lobe_folder)
        self.lesion_path_map = self._path_map(self.lesion_folder)
        self.pseudo_vessel_path_map = self._path_map(self.pseudo_vessel_folder)

    @staticmethod
    def _path_map(folder):
        return {Path(f).stem: f
                for f in glob.glob(os.path.join(folder, "*.mha"))}

    def __len__(self):
        return len(self.uids)

    def __getitem__(self, index):
        return self.get_data(self.uids[index])

    def _maybe_on_premise(self, path, name):
        """With ON_PREMISE_ROOT set, read the scan from a copy there (made
        on first use); the archive's file when the copy fails."""
        if self.ON_PREMISE_ROOT is None:
            return path
        cache_dir = os.path.join(self.ON_PREMISE_ROOT, self.__class__.__name__)
        os.makedirs(cache_dir, exist_ok=True)
        cached = os.path.join(cache_dir, f"{name}.mha")
        try:
            if not os.path.exists(cached):
                shutil.copyfile(path, cached)
            return cached
        except OSError:
            return path

    def get_scan(self, name):
        path = self._maybe_on_premise(self.scan_path_map[name], name)
        d = read_mha(path)
        return d["array"], d["origin"], d["direction"], d["spacing"]

    def get_mask(self, path_map, name):
        if name not in path_map or not os.path.exists(path_map[name]):
            return None
        return read_mha(path_map[name])["array"]

    def get_data(self, uid):
        pid, sid = uid.split("_")
        scan, origin, direction, spacing = self.get_scan(uid)
        original_size = scan.shape
        series_meta = self.all_metas[(pid, sid)]
        lobe = self.get_mask(self.lobe_path_map, uid).astype(np.uint8)
        lesion_arr = self.get_mask(self.lesion_path_map, uid)
        lesion = (np.zeros_like(lobe) if lesion_arr is None
                  else lesion_arr.astype(np.uint8))
        vessel_arr = self.get_mask(self.pseudo_vessel_path_map, uid)
        vessel = (np.zeros_like(lobe) if vessel_arr is None
                  else vessel_arr.astype(np.uint8))
        if self.use_masked_scan:
            scan = scan.copy()
            scan[lobe == 0] = -2048
        base = {"uid": uid, "patient_meta": series_meta,
                "size": scan.shape, "spacing": spacing,
                "original_spacing": spacing, "original_size": original_size,
                "original_origin": origin, "original_direction": direction,
                "origin": origin, "direction": direction}
        if "cle" in series_meta:
            base["cle"] = series_meta["cle"]
        ret = {"#image": scan.astype(np.int16),
               "#lobe_reference": lobe,
               "#lesion_reference": lesion,
               "#vessel_reference": vessel,
               "meta": base}
        return self.transforms(ret) if self.transforms else ret


class RadboudCOVIDLobeVesselChunk(RadboudCOVID):
    """Training lobe chunks (task "wss_chunk", prepare_data's layout):
    memo.csv keyed by `<pid>_<study>-<lobe>` with each lobe's CT severity
    score; the pseudo-lesion candidates are the lobe's voxels above a
    0.75-scaled Otsu threshold of the [0, 1]-windowed scan, computed on
    the fly. Meta holds the score under both spellings, `ctss` and `cle`."""

    ON_PREMISE_ROOT = None

    def __init__(self, archive_path, case_uids, transforms=None,
                 keep_sorted=True, crop_border=5, task="wss_chunk"):
        self.transforms = transforms
        self.archive_path = archive_path
        self.crop_border = crop_border
        self.lobe_folder = os.path.join(archive_path, task, "lobes")
        self.scan_folder = os.path.join(archive_path, task, "images")
        self.pseudo_vessel_folder = os.path.join(archive_path, task,
                                                 "pseudo_vessels")
        self.all_metas, _ = read_csv_in_dict(
            os.path.join(archive_path, task, "memo.csv"), "uid")
        self.case_uids = set(case_uids)
        self.uids = [uid for uid in self.all_metas
                     if f"{self.all_metas[uid]['patientid']}_"
                        f"{self.all_metas[uid]['study']}" in self.case_uids]
        if keep_sorted:
            self.uids = sorted(self.uids)
        else:
            self.uids = random.sample(self.uids, len(self.uids))
        self.scan_path_map = self._path_map(self.scan_folder)
        self.lobe_path_map = self._path_map(self.lobe_folder)
        self.pseudo_vessel_path_map = self._path_map(self.pseudo_vessel_folder)

    @classmethod
    def get_series_uids(cls, csv_file):
        """The `<pid>_<study>` cases of a chunk memo.csv."""
        metas, _ = read_csv_in_dict(csv_file, "uid")
        return sorted({f"{m['patientid']}_{m['study']}"
                       for m in metas.values()})

    def get_data(self, lobe_wise_uid):
        lobe_id = lobe_wise_uid.rpartition("-")[-1]
        scan, origin, direction, spacing = self.get_scan(lobe_wise_uid)
        meta = self.all_metas[lobe_wise_uid]
        ctss = int(meta["ctss"])
        lobe = self.get_mask(self.lobe_path_map, lobe_wise_uid).astype(np.uint8)
        vessel_arr = self.get_mask(self.pseudo_vessel_path_map, lobe_wise_uid)
        vessel = (np.zeros_like(lobe) if vessel_arr is None
                  else vessel_arr.astype(np.uint8))
        vessel = np.logical_and(vessel > 0, lobe > 0)

        w_scan = windowing_np(scan, to_span=(0, 1))
        _, th = binary_cam_np(w_scan[lobe > 0], 0.75)
        lesion_candidate = (w_scan > th) & (lobe > 0)

        base = {"uid": lobe_wise_uid, "patient_meta": meta,
                "ctss": ctss, "cle": ctss,
                "size": scan.shape, "spacing": spacing,
                "original_spacing": spacing, "original_size": scan.shape,
                "original_origin": origin, "original_direction": direction,
                "origin": origin, "direction": direction}
        ret = {"#image": scan.astype(np.int16),
               "#pseudo_lesion_reference": lesion_candidate.astype(np.uint8),
               "#lobe_reference": lobe,
               "#vessel_reference": vessel.astype(np.uint8),
               "ctss": ctss,
               "lobe_id": lobe_id,
               "meta": base}
        return self.transforms(ret) if self.transforms else ret
