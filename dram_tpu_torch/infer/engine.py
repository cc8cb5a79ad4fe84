"""Restartable batch inference: scans on disk -> masks, heatmaps and
scores on disk.

Port of dram_tpu/infer/engine.py:LesionSegTest (:51). For each scan of a
test split (RadboudCOVID, scored against its references) or of a
deployment directory (TestDataset, no references), one of two paths:

* fast (USE_FAST_INFERENCE, the default), by the C++ host prep and one of
  two wires (FAST_WIRE): "wc" (the default), `prep_scan_chunks` on the
  host, then FastScanPipeline.process_chunks on the device; "w8",
  `prep_scan` (the windowed 8-bit scan of the lung window), then
  FastScanPipeline.process_prepped, which crops and resizes the lobe
  chunks on the device; outputs arrive on the scan grid;
* host-stitch: the scan resampled to TEST_RESAMPLE_SPACING; each lobe
  cropped with a 5 mm border, masked to PAD_VALUE outside, windowed,
  resized to the model's chunk and run alone (batch 1); the refined CAM
  resized back, ReLU'd, max-normalised, gated by the lobe's predicted
  class and stitched; Otsu within the lung, the intensity post rule and
  the vessel exclusion; everything resampled back to the scan grid.

Then the scan is scored (IoU / Dice with and without the post rule, the
per-lobe class accuracy) and archived: `<task>/<uid>.mha`, `heatmap/`,
`post/`, `screenshots/`, `records.csv` (its rows also returned by `run`),
`lobewise.csv` and the confusion matrix `cm.jpg`. A scan whose
`<uid>.mha` exists is skipped; a scan that fails is logged with its
traceback and the run goes on. The per-lobe class comes from the
predicted lesion ratio through the CTSS interval table, as in dram_tpu.

Scan-level sharding (SHARD_SCANS, the DRAM_SHARD_SCANS environment
variable or the CLI's --shard; dram_tpu/infer/engine.py:314-331,430-459):
N scans in flight on N threads, each scan on one device of the engine's
device list with that device's own copy of the model (dram_tpu's
_params_on), its chunk upload placed there. -1 takes every device; the
count is clamped to the devices; the host-stitch path and FAST_WIRE other
than "wc" run serially with a warning, as in dram_tpu. The rows of
records.csv are written once after the sharded run, in scan order.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import torch

from ..core.ops import binary_cam_np, find_crops_np, windowing_np
from ..core.resample import resize3d_np
from ..data import transforms as T
from ..data.datasets import RadboudCOVID, TestDataset
from ..data.hostprep import prep_scan
from ..data.io import write_array_to_mha_itk
from ..losses.interval_reg import ratio_to_label
from ..train.runner import JobRunner
from ..utils import AverageMeter, write_records
from ..viz import (draw_mask_tile_singleview_heatmap,
                   plot_confusion_matrix_from_data)
from .fast import FastScanPipeline, prep_scan_chunks

WIRES = ("wc", "w8")


def _indexed(device):
    """`device` as a torch.device, "cuda" as the current CUDA device
    (so that "cuda" and "cuda:0" name one device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _np_metrics(pred, target, smooth=1e-5):
    inter = np.logical_and(pred, target).sum()
    union = np.logical_or(pred, target).sum()
    iou = (inter + smooth) / (union + smooth)
    dice = (2.0 * inter + smooth) / (pred.sum() + target.sum() + smooth)
    return float(iou), float(dice)


class LesionSegTest:
    """Restartable batch inference runner on `device` (default "cuda";
    raises when CUDA is asked for and absent). `settings_module` is a
    Settings, a settings file's path, a settings module or a
    with_settings namespace; with `scan_path` (and `lobe_path`) the scans
    of that directory run without references, else the settings'
    TEST_CSV split of DB_PATH. `devices`: the devices scan-level sharding
    spreads scans over (default every local GPU of a CUDA engine, the
    engine's device otherwise); an entry may repeat."""

    def __init__(self, settings_module=None, scan_path=None, lobe_path=None,
                 output_path=None, task_name="test", use_fast_path=None,
                 device="cuda", devices=None):
        self._runner = JobRunner(settings_module, device=device)
        self.settings = self._runner.settings
        self.logger = self._runner.logger
        self.exp_path = self._runner.exp_path
        self.device = self._runner.device
        self.output_path = output_path
        self.task_name = task_name

        s = self.settings
        if use_fast_path is None:
            use_fast_path = bool(getattr(s, "USE_FAST_INFERENCE", True))
        self.use_fast_path = use_fast_path
        self.wire = str(getattr(s, "FAST_WIRE", "wc"))
        if use_fast_path and self.wire not in WIRES:
            raise ValueError(f"FAST_WIRE={self.wire!r}: one of {WIRES}")
        if devices is None:
            devices = [torch.device("cuda", i) for i in
                       range(torch.cuda.device_count())] \
                if self.device.type == "cuda" else [self.device]
        self.devices = [_indexed(d) for d in devices]
        # fast path: raw grids in, the pipeline does the iso resample;
        # host-stitch path: the host resample up front
        resample_t = None if use_fast_path else T.Compose([
            T.Resample(mode="fixed_spacing", factor=s.TEST_RESAMPLE_SPACING,
                       size=s.RESAMPLE_SIZE)])
        if scan_path is not None:
            self.test_set = TestDataset(scan_path, lobe_path,
                                        transforms=resample_t)
            self.has_references = False
        else:
            self.test_set = RadboudCOVID(
                s.DB_PATH, RadboudCOVID.get_series_uids(s.TEST_CSV),
                task=task_name if os.path.isdir(
                    os.path.join(s.DB_PATH, task_name)) else "wss",
                keep_sorted=True, transforms=resample_t)
            self.has_references = True

        self.settings.RELOAD_CHECKPOINT = True
        self._runner.init()
        self._runner.reload_model_from_cache()
        self.model = self._runner.model
        self.trace = False
        self._trace_uid = "chunk"
        self.saved_model_states = {
            "epoch": self._runner.epoch_n,
            "iteration": self._runner.current_iteration,
            "metrics": dict(self._runner.model_metrics_save_dict)}
        self._fast_pipes = {}
        self._pipe_lock = threading.Lock()
        # per archived scan: uid and the ms of its stages (wall ms of load,
        # prep, archive and the screenshots within it; device ms of pre /
        # model / post, the pipeline's stage_ms)
        self.timings = []

    def _fast(self, device=None):
        """The device pipeline on `device` (the engine's by default),
        built once a device; a device other than the engine's gets its
        own copy of the model."""
        device = _indexed(self.device if device is None else device)
        with self._pipe_lock:
            if device not in self._fast_pipes:
                s = self.settings
                model = self.model if device == _indexed(self.device) \
                    else copy.deepcopy(self.model)
                self._fast_pipes[device] = FastScanPipeline(
                    model, device=device,
                    chunk_size=tuple(s.RESAMPLE_SIZE),
                    windowing_span=(s.WINDOWING_MIN, s.WINDOWING_MAX),
                    pad_value=float(s.PAD_VALUE))
            return self._fast_pipes[device]

    def _shard_count(self):
        """Scans in flight: SHARD_SCANS (or DRAM_SHARD_SCANS); 0 / 1
        serial, -1 every device of the list; clamped to the list. Only
        the fast "wc" path places a scan's work on a device of its own,
        so sharding requires it."""
        n = int(getattr(self.settings, "SHARD_SCANS",
                        os.environ.get("DRAM_SHARD_SCANS", "0")) or 0)
        if n == -1:
            n = len(self.devices)
        n = max(1, min(n, len(self.devices)))
        if n > 1 and not self.use_fast_path:
            self.logger.warning("SHARD_SCANS needs the fast path; serial.")
            return 1
        if n > 1 and self.wire != "wc":
            self.logger.warning("SHARD_SCANS needs FAST_WIRE='wc'; serial.")
            return 1
        return n

    def process_scan_fast(self, scan_data, device=None):
        """Fast path: the C++ host prep of the FAST_WIRE wire, then the
        device pipeline (on `device` when given); outputs arrive on the
        scan grid."""
        s = self.settings
        meta = scan_data["meta"]
        args = (scan_data["#image"].astype(np.int16),
                scan_data["#lobe_reference"], meta["spacing"])
        kw = dict(iso_spacing=float(s.TEST_RESAMPLE_SPACING),
                  pad_value=float(s.PAD_VALUE),
                  vessel_u8=scan_data.get("#vessel_reference"),
                  windowing_span=(s.WINDOWING_MIN, s.WINDOWING_MAX))
        t0 = time.perf_counter()
        if self.wire == "wc":
            prep = prep_scan_chunks(*args, **kw,
                                    chunk_size=tuple(s.RESAMPLE_SIZE))
        else:
            prep = prep_scan(*args, **kw)
        prep_ms = (time.perf_counter() - t0) * 1e3
        if self.wire == "wc":
            out = self._fast(device).process_chunks(prep, want_heatmap=True)
        else:
            out = self._fast(device).process_prepped(prep, want_heatmap=True)
        cls_preds, cls_targets = [], []
        for li in range(1, 6):
            target = None
            if self.has_references and "patient_meta" in meta:
                col = RadboudCOVID.metric_k_mapping[li]
                target = int(float(meta["patient_meta"].get(col, 0)))
            if out["present"][li - 1] < 1:
                if target is not None:
                    cls_preds.append(target)
                    cls_targets.append(target)
                continue
            cls_preds.append(ratio_to_label([out["ratios"][li - 1]])[0])
            if target is not None:
                cls_targets.append(target)
        return {"pred": out["pred"], "post": out["post"],
                "heatmap": out["heatmap_u8"].astype(np.float32) / 255.0,
                "cls_preds": cls_preds, "cls_targets": cls_targets,
                "ms": {"prep": prep_ms, **out["stage_ms"]}}

    # ------------------------------------------------------------------
    def preprocessing(self):
        s = self.settings
        return [T.Windowing(min=s.WINDOWING_MIN, max=s.WINDOWING_MAX),
                T.Resample(mode=s.RESAMPLE_MODE, factor=s.RESAMPLE_SPACING,
                           size=s.RESAMPLE_SIZE)]

    def infer_lobe_chunk(self, scan_chunk, lobe_chunk, spacing, ms=None):
        """chunk (cropped, masked, native grid) -> (relu-normed CAM at the
        chunk grid, predicted ordinal class). With `ms`, adds the wall ms
        of the host preprocessing ("prep") and of the forward ("model")."""
        ms = {} if ms is None else ms
        t0 = time.perf_counter()
        pre = T.Compose(self.preprocessing())
        ret = pre({"#image": scan_chunk.astype(np.int16),
                   "#lobe_reference": lobe_chunk.astype(np.uint8),
                   "meta": {"size": scan_chunk.shape, "spacing": spacing}})
        image = torch.from_numpy(np.ascontiguousarray(
            ret["#image"][None, ..., None], np.float32)).to(self.device)
        t1 = time.perf_counter()
        with torch.no_grad():
            dense, refined = self.model(image)
        out = refined[0, ..., 0].float().cpu().numpy()
        t2 = time.perf_counter()
        ms["prep"] = ms.get("prep", 0.0) + (t1 - t0) * 1e3
        ms["model"] = ms.get("model", 0.0) + (t2 - t1) * 1e3
        if self.trace:
            # before/after-refinement heatmap tiles
            trace_dir = os.path.join(self.output_path or self.exp_path,
                                     "apply_attention")
            d_np = dense[0, ..., 0].float().cpu().numpy()
            lobe_np = np.asarray(ret["#lobe_reference"]) > 0
            draw_mask_tile_singleview_heatmap(
                windowing_np(np.asarray(ret["#image"]),
                             from_span=(0, 1)).astype(np.uint8),
                [[(windowing_np(d_np, from_span=None) * lobe_np)
                  .astype(np.uint8)],
                 [(windowing_np(out, from_span=None) * lobe_np)
                  .astype(np.uint8)]],
                out > 0, 5,
                os.path.join(trace_dir, f"{self._trace_uid}"),
                titles=["dram", "dram_refine"])
        lobe80 = np.asarray(ret["#lobe_reference"]) > 0
        probs = 1.0 / (1.0 + np.exp(-out))
        pred_ratio = float(probs[lobe80].mean()) if lobe80.any() else 0.0
        cls_pred = ratio_to_label([pred_ratio])[0]

        # the reference's order: resize the raw logits back first, then
        # ReLU and max-normalise
        cam = resize3d_np(out, scan_chunk.shape, "trilinear")
        cam = np.maximum(cam, 0.0)
        m = cam.max()
        if m > 0:
            cam = cam / m
        if cls_pred < 1e-7:
            cam[:] = 0.0
        return cam, cls_pred

    def process_scan(self, scan_data):
        """Host-stitch path: one scan -> dict of outputs at the test grid
        (before the resample back)."""
        s = self.settings
        scan = scan_data["#image"]
        lobe = scan_data["#lobe_reference"]
        meta = scan_data["meta"]
        crop_border = getattr(self.test_set, "crop_border", 5)
        htp = np.zeros(scan.shape, np.float32)
        cls_preds, cls_targets = [], []
        ms = {"prep": 0.0, "model": 0.0}
        for lobe_label in range(1, 6):
            lobe_binary = lobe == lobe_label
            target = None
            if self.has_references and "patient_meta" in meta:
                col = RadboudCOVID.metric_k_mapping[lobe_label]
                target = int(float(meta["patient_meta"].get(col, 0)))
            if lobe_binary.sum() < 1:
                if target is not None:
                    cls_preds.append(target)
                    cls_targets.append(target)
                continue
            crop = find_crops_np(lobe_binary, meta["spacing"], crop_border)
            lobe_chunk = lobe_binary[crop]
            scan_chunk = scan[crop].copy()
            scan_chunk[lobe_chunk == 0] = s.PAD_VALUE
            self._trace_uid = f"{meta.get('uid', 'scan')}_{lobe_label}"
            cam, cls_pred = self.infer_lobe_chunk(scan_chunk, lobe_chunk,
                                                  meta["spacing"], ms)
            cls_preds.append(cls_pred)
            if target is not None:
                cls_targets.append(target)
            mask = lobe_chunk > 0
            htp[crop][mask] = cam[mask]

        t0 = time.perf_counter()
        lung = lobe > 0
        _, th = binary_cam_np(htp[lung])
        lesion_pred = htp > th
        w_scan = windowing_np(scan, to_span=(0, 1))
        _, th_i = binary_cam_np(w_scan[lung], 0.75)
        vessel = scan_data.get("#vessel_reference", np.zeros_like(lobe))
        lesion_pred_post = np.logical_and(
            np.logical_and(lesion_pred, w_scan > th_i),
            np.logical_not(vessel > 0)).astype(np.uint8)
        ms["post"] = (time.perf_counter() - t0) * 1e3
        return {"heatmap": htp, "pred": lesion_pred.astype(np.uint8),
                "post": lesion_pred_post, "cls_preds": cls_preds,
                "cls_targets": cls_targets, "ms": ms}

    # ------------------------------------------------------------------
    def archive_results(self, scan, heatmap, pred, post_pred, ref, meta):
        """Write the pred, heatmap and post masks and the screenshots;
        returns the wall ms of the screenshots."""
        output_path = os.path.join(self.output_path, self.task_name)
        post_path = os.path.join(output_path, "post")
        heatmap_path = os.path.join(output_path, "heatmap")
        screenshots = os.path.join(output_path, "screenshots")
        for d in (post_path, heatmap_path, screenshots):
            os.makedirs(d, exist_ok=True)
        uid = meta["uid"]
        heat_u8 = windowing_np(heatmap, from_span=(0, 1)).astype(np.uint8)
        kw = dict(origin=meta.get("origin", (0, 0, 0)),
                  direction=meta.get("direction"),
                  spacing=meta["original_spacing"])
        write_array_to_mha_itk(output_path, [pred.astype(np.uint8)], [uid],
                               type=np.uint8, **kw)
        write_array_to_mha_itk(heatmap_path, [heat_u8], [uid],
                               type=np.uint8, **kw)
        write_array_to_mha_itk(post_path, [post_pred.astype(np.uint8)], [uid],
                               type=np.uint8, **kw)
        if ref is None:
            ref = np.zeros_like(pred)
        t0 = time.perf_counter()
        try:
            draw_mask_tile_singleview_heatmap(
                windowing_np(scan).astype(np.uint8),
                [[(pred * 255).astype(np.uint8)],
                 [(post_pred * 255).astype(np.uint8)],
                 [(ref * 255).astype(np.uint8)],
                 [heat_u8]],
                np.logical_or(pred > 0, ref > 0), 5,
                os.path.join(screenshots, uid) + "/",
                titles=["pred_lesion", "pred_lesion_post", "lesion",
                        "pred_cam"])
        except Exception as e:  # the screenshots are cosmetic
            self.logger.warning(f"screenshot failed for {uid}: {e}")
        return (time.perf_counter() - t0) * 1e3

    def _run_one(self, scan_idx, uid, scan_data=None, load_ms=0.0,
                 device=None):
        """One scan: load -> infer (on `device` when given) -> score ->
        archive. Returns (records row, cls_preds, cls_targets).
        `scan_data` may come from the prefetch thread, which took
        `load_ms` to load it."""
        t1 = time.perf_counter()
        if scan_data is None:
            scan_data, load_ms = self._load(scan_idx)
            t1 = time.perf_counter()
        meta = scan_data["meta"]
        if self.use_fast_path:
            out = self.process_scan_fast(scan_data, device)
        else:
            out = self.process_scan(scan_data)
        t2 = time.perf_counter()

        if self.use_fast_path:
            # fast-path outputs are already at the original grid
            pred = out["pred"].astype(np.uint8)
            post = out["post"].astype(np.uint8)
            heat = out["heatmap"]
            scan_b = scan_data["#image"].astype(np.float32)
        else:
            # resample everything back to the original grid
            spacing = list(np.asarray(meta["spacing"]).flatten())
            orig_spacing = list(
                np.asarray(meta["original_spacing"]).flatten())
            orig_size = [int(v) for v in
                         np.asarray(meta["original_size"]).flatten()]
            pred, _ = T.resample_array(out["pred"], spacing,
                                       orig_spacing, orig_size, "nearest")
            post, _ = T.resample_array(out["post"], spacing,
                                       orig_spacing, orig_size, "nearest")
            heat, _ = T.resample_array(out["heatmap"], spacing,
                                       orig_spacing, orig_size, "linear")
            scan_b, _ = T.resample_array(
                scan_data["#image"].astype(np.float32), spacing,
                orig_spacing, orig_size, "linear")
            pred = pred.astype(np.uint8)
            post = post.astype(np.uint8)

        row = {"uid": uid}
        ref = None
        if self.has_references and "#lesion_reference" in scan_data:
            if self.use_fast_path:
                lesion = scan_data["#lesion_reference"]
            else:
                lesion, _ = T.resample_array(
                    scan_data["#lesion_reference"], spacing,
                    orig_spacing, orig_size, "nearest")
            ref = (lesion > 0).astype(np.uint8)
            iou, dice = _np_metrics(pred > 0, ref > 0)
            iou_p, dice_p = _np_metrics(post > 0, ref > 0)
            acc = float(np.mean(np.asarray(out["cls_preds"]) ==
                                np.asarray(out["cls_targets"]))) \
                if out["cls_targets"] else float("nan")
            row.update({"iou": iou, "iou_post": iou_p, "dice": dice,
                        "dice_post": dice_p, "acc": acc})
            self.logger.info(f"scan {uid}: iou {iou:.4f}, "
                             f"iou_post {iou_p:.4f}, dice {dice:.4f}")
        t3 = time.perf_counter()
        shots_ms = self.archive_results(scan_b, heat, pred, post, ref, meta)
        t4 = time.perf_counter()
        self.timings.append({"uid": uid, "load": load_ms,
                             "infer": (t2 - t1) * 1e3, **out["ms"],
                             "archive": (t4 - t3) * 1e3,
                             "screenshots": shots_ms,
                             "total": load_ms + (t4 - t1) * 1e3})
        return row, out["cls_preds"], out["cls_targets"]

    def _run_serial(self, rec_file, rows, n_written, scan_timer, all_preds,
                    all_targets):
        """Every scan in turn, the next one's load prefetched: the file
        read and MHA decode overlap this scan's device and archive work;
        a failed prefetch is loaded again (and raises) inside _run_one,
        so a bad file fails its own scan only. Appends to `rows`, writes
        records.csv every fifth scan and at the last; returns the count
        of rows written."""
        n = len(self.test_set)
        with ThreadPoolExecutor(1) as prefetch_pool:
            nxt = prefetch_pool.submit(self._load, 0) if n else None
            for scan_idx in range(n):
                uid = self.test_set.uids[scan_idx]
                try:
                    scan_data, load_ms = nxt.result()
                except Exception:
                    scan_data, load_ms = None, 0.0
                if scan_idx + 1 < n:
                    nxt = prefetch_pool.submit(self._load, scan_idx + 1)
                start = time.time()
                try:
                    row, preds, targets = self._run_one(scan_idx, uid,
                                                        scan_data, load_ms)
                    dt = time.time() - start
                    all_preds.extend(preds)
                    all_targets.extend(targets)
                    scan_timer.update(dt)
                    rows.append(row)
                    if scan_idx % 5 == 0 or scan_idx == n - 1:
                        write_records(rec_file, rows, "uid")
                        n_written = len(rows)
                    self.logger.info(f"Finished {scan_idx} ({uid}) "
                                     f"in {dt:.2f}s.")
                except Exception:
                    self.logger.error(f"Cannot process scan {scan_idx} "
                                      f"({uid}): {traceback.format_exc()}")
        return n_written

    def _run_sharded(self, n_shard, rows, scan_timer, preds, targets):
        """Every scan on `n_shard` threads, scan i on device i mod
        n_shard of the list; a scan that fails is logged and the others
        go on. Appends the new rows to `rows` in scan order."""
        devices = self.devices[:n_shard]
        self.logger.info(f"scan-sharded inference over {len(devices)} "
                         f"devices: {[str(d) for d in devices]}")

        def handle(i):
            device = devices[i % len(devices)]
            start = time.time()
            # the kernels launch on the current device's stream: make it
            # this scan's device in this thread
            with torch.cuda.device(device) if device.type == "cuda" \
                    else contextlib.nullcontext():
                out = self._run_one(i, self.test_set.uids[i], device=device)
            return out, time.time() - start

        results = {}
        with ThreadPoolExecutor(len(devices)) as pool:
            futs = {pool.submit(handle, i): i
                    for i in range(len(self.test_set))}
            for fut in as_completed(futs):
                i = futs[fut]
                try:
                    results[i] = fut.result()
                except Exception:
                    self.logger.error(f"Cannot process scan {i} "
                                      f"({self.test_set.uids[i]}): "
                                      f"{traceback.format_exc()}")
        for i in sorted(results):
            (row, p, t), dt = results[i]
            preds.extend(p)
            targets.extend(t)
            scan_timer.update(dt)
            rows.append(row)

    def _load(self, scan_idx):
        """test_set[scan_idx] and its wall ms (the prefetch thread's)."""
        t0 = time.perf_counter()
        scan_data = self.test_set[scan_idx]
        return scan_data, (time.perf_counter() - t0) * 1e3

    def run(self):
        """Process every scan not archived yet; returns the records rows
        (those of an earlier run's records.csv first)."""
        if self.output_path is None:
            st = self.saved_model_states
            self.output_path = os.path.join(
                self.exp_path, f"{st['epoch']}_{st['iteration']}")
        output_path = os.path.join(self.output_path, self.task_name)
        os.makedirs(output_path, exist_ok=True)
        with open(output_path + "/settings.txt", "wt", newline="") as fp:
            fp.write(str(self.settings))

        # restartability: skip archived scans
        uids = []
        for uid in self.test_set.uids:
            if os.path.exists(output_path + f"/{uid}.mha"):
                self.logger.warning(f"already archived {uid}")
            else:
                uids.append(uid)
        self.test_set.uids = uids
        if hasattr(self.test_set, "series_uids"):
            self.test_set.series_uids = uids
        self.logger.info(f"start {len(uids)} scans after exclusion.")

        rec_file = output_path + "/records.csv"
        rows = []
        if os.path.exists(rec_file):
            with open(rec_file, "rt", newline="") as fp:
                rows = list(csv.DictReader(fp))
        n_written = len(rows)
        scan_timer = AverageMeter()
        all_cls_preds, all_cls_targets = [], []

        n_shard = self._shard_count()
        if n_shard > 1:
            self._run_sharded(n_shard, rows, scan_timer, all_cls_preds,
                              all_cls_targets)
        else:
            n_written = self._run_serial(rec_file, rows, n_written,
                                         scan_timer, all_cls_preds,
                                         all_cls_targets)
        if len(rows) > n_written:
            # the rows since the last write, when the last scan failed
            write_records(rec_file, rows, "uid")

        if all_cls_targets:
            try:
                plot_confusion_matrix_from_data(
                    all_cls_targets, all_cls_preds, labels=list(range(6)),
                    save_path=output_path + "/cm")
            except Exception as e:  # matplotlib may be absent
                self.logger.warning(f"cm plot failed: {e}")
            with open(output_path + "/lobewise.csv", "wt",
                      newline="") as fp:
                w = csv.writer(fp)
                w.writerow(["", "target", "pred"])
                w.writerows((i, t, p) for i, (t, p) in enumerate(
                    zip(all_cls_targets, all_cls_preds)))
        self.logger.info(f"Finished testing, avg {scan_timer.avg:.2f}s/scan")
        return rows
