"""Full-scan datasets of the inference engine over the `#key` / meta
sample-dict contract.

Port of dram_tpu/data/datasets.py: `Dataset` (:28), `_read_volume` (:38),
`TestDataset` (:149; bare scan + lobe pairs for deployment) and
`RadboudCOVID` (:194; the scored test split), on the port's MHA codec.
The training datasets are not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import glob
import os
import random
import shutil
from pathlib import Path

import numpy as np

from ..utils import read_csv_in_dict_double
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
