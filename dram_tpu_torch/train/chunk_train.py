"""The training epoch loop: lobe chunks from disk, validation on full
scans, records, checkpoints and resume.

Port of dram_tpu/train/trainer.py:LesionSegChunkTrain (:650-1073). Per
epoch: `reset_data` rebuilds the chunk dataset
(TRAIN_DATASET_CLS), its balanced sampler (SAMPLER_CLS, seeded with
RANDOM_SEED + 9973 * epoch) and the threaded loader, whose threads also
pack each batch for the wire (TRAIN_WIRE); `train` takes the epoch's
steps, the lr set from the scheduler before each, the loss read one step
late so the host never waits for the card; `validate` runs every
validation scan (VAL_DATASET_CLS over VALID_CSV) through
`evaluate_scan`: the chunk wire's prep and
FastScanPipeline.process_chunks_val by default, the host-stitch loop
(`_evaluate_scan_hoststitch`, one lobe at a time) with
VAL_USE_FAST_PIPELINE = False or TRACE; `run` validates when
epoch % VAL_EPOCHS == 0, at the last epoch and for epochs under 15,
steps the scheduler after each validation (its lr written into the
optimizer at once, as torch's schedulers do), appends a row to
records.csv, and saves `{epoch}.ckpt` every STATE_EPOCHS and at the end.
With PROFILE_DIR set, the steps of epoch PROFILE_EPOCH (default 1) run
under torch.profiler, whose Chrome trace goes into PROFILE_DIR (dram_tpu
writes a JAX trace there).
A resumed run starts again at the checkpoint's epoch, as the JAX loop
does.

On N ranks (torchrun; runner.py): the sampler is seeded the same on every
rank, so all agree on the global batch; `_device_batch` pads it to the
world and hands each rank its rows and their weights (:756-782), from its
own rows only with PER_PROCESS_LOADING; validation runs once, on rank 0,
and its result reaches every rank; only rank 0 writes records.csv,
scalars, tiles and checkpoints.

One nn.Module serves both modes. Two traps follow, each handled here:
FastScanPipeline puts the model in eval mode, and TrainStep puts it back
in train mode at every step (else BatchNorm would train on its running
statistics); validation restores the mode it found. The CUDA eval conv
raises under grad, so every eval forward runs under torch.no_grad().
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..configs import get_callable_by_name
from ..core.mesh import (broadcast_object, local_batch_rows, pad_batch,
                         rank, world_size)
from ..core.ops import find_crops_np, windowing_np
from ..core.resample import resize3d_np
from ..data import transforms as T
from ..data.pipeline import DataLoader, collate_dict
from ..infer.fast import FastScanPipeline, prep_scan_chunks
from ..losses.interval_reg import ratio_to_label
from ..utils import AverageMeter, write_records
from ..viz import (draw_mask_tile_single_view,
                   draw_mask_tile_singleview_heatmap,
                   plot_confusion_matrix_from_data)
from .runner import JobRunner
from .trainer import (MaskWireLatch, batch_tensors, fix_random_seeds,
                      pack_train_batch, unpack_image_wire)

DATASETS = "dram_tpu_torch.data.datasets."


class LesionSegChunkTrain(JobRunner):
    """Chunk training runner on `device` (default "cuda"; raises when CUDA
    is asked for and absent). `settings_module` is a Settings, a settings
    file's path, a settings module or a with_settings namespace."""

    def __init__(self, settings_module=None, device="cuda"):
        super().__init__(settings_module, device)
        fix_random_seeds(int(getattr(self.settings, "RANDOM_SEED", 33)))
        self.init()
        self.init_training()
        self.reload_model_from_cache()
        self.trace = False
        self._mask_latch = MaskWireLatch()
        self._val_pipe = None
        # per epoch: its steps, their losses and times, peak MiB, the
        # validation's per-scan ms and the checkpoint's save ms
        self.history = []
        self.reset_data()
        self.logger.info(
            f"batchsize:{self.settings.TRAIN_BATCH_SIZE}, "
            f"input_resize:{self.settings.RESAMPLE_SIZE}")
        rec = self.exp_path + "/records.csv"
        self.train_records = []
        if os.path.exists(rec):
            with open(rec, newline="") as fp:
                self.train_records = list(csv.DictReader(fp))

    # -- data ----------------------------------------------------------
    def preprocessing(self):
        s = self.settings
        return [T.Windowing(min=s.WINDOWING_MIN, max=s.WINDOWING_MAX),
                T.Resample(mode=s.RESAMPLE_MODE, factor=s.RESAMPLE_SPACING,
                           size=s.RESAMPLE_SIZE)]

    def val_preprocessing(self):
        s = self.settings
        return [T.Resample(mode="fixed_spacing", factor=s.RESAMPLE_SPACING,
                           size=s.RESAMPLE_SIZE)]

    def get_data_transforms(self, is_train):
        if is_train:
            aug = T.ensemble_augmentation(getattr(self.settings, "AUG_RATIO",
                                                  0))
            return T.Compose(self.preprocessing() + [aug, T.RemoveMeta()])
        return T.Compose(self.val_preprocessing())

    def reset_data(self):
        """This epoch's training dataset, sampler and loader, and the
        validation dataset."""
        s = self.settings
        seed = int(getattr(s, "RANDOM_SEED", 33))
        ds_cls = get_callable_by_name(getattr(
            s, "TRAIN_DATASET_CLS", DATASETS + "RadboudCOVIDLobeVesselChunk"))
        sampler_cls = get_callable_by_name(getattr(
            s, "SAMPLER_CLS", "dram_tpu_torch.data.sampler.LobeChunkCTSSSampler"))
        memo_csv = getattr(s, "TRAIN_MEMO_CSV",
                           os.path.join(s.DB_PATH, "wss_chunk", "memo.csv"))
        tr_dataset = ds_cls(s.DB_PATH, ds_cls.get_series_uids(memo_csv),
                            transforms=self.get_data_transforms(True))
        # the loss's epoch-static transform draw (the equivariance
        # losses), where the loss has one
        if hasattr(self.loss_func, "epoch_reseed"):
            self.loss_func.epoch_reseed(seed + 7919 * self.epoch_n)
        sampler = sampler_cls(
            self.logger, tr_dataset, self.loader_batch_size,
            balance_label_count=s.BALANCED_LABEL_COUNT,
            seed=seed + 9973 * self.epoch_n)
        self.sampler = sampler
        self.ctss_frequency_map = sampler.ctss_frequency_map
        self.ctss_frequency_array = sampler.frequency_array()
        self.class_weights = sampler.class_weights
        wire, latch = self.train_wire, self._mask_latch

        def collate_packed(samples):
            return pack_train_batch(collate_dict(samples), wire, latch)

        self.tr_loader = DataLoader(
            tr_dataset, sampler, batch_size=self.loader_batch_size,
            drop_last=True, num_workers=getattr(s, "NUM_WORKERS", 4) or 0,
            collate_fn=collate_packed, row_range=self._loader_row_range)
        self.num_steps = len(self.tr_loader)

        val_cls = get_callable_by_name(getattr(
            s, "VAL_DATASET_CLS", DATASETS + "RadboudCOVID"))
        self.val_dataset = val_cls(
            s.DB_PATH, val_cls.get_series_uids(s.VALID_CSV),
            transforms=self.get_data_transforms(False), keep_sorted=True)

    # -- train ---------------------------------------------------------
    def _device_batch(self, batch):
        """The TrainStep arguments of this rank: one process takes the
        whole batch; on N ranks the global batch is padded to the world
        with wrap-around rows of weight 0 and the rank takes its rows, or,
        with per-rank loading, its own rows are padded to its share.
        Returns (arguments, rows of the padded global batch)."""
        world = world_size(self.group)
        keys = ("images", "lobes", "lesions", "ctss", "span")
        arrays = tuple(batch[k] for k in keys)
        b = int(arrays[0].shape[0])
        if world == 1:
            weights = np.ones(b, np.float32)
        elif self._local_rows is not None:
            (lo, hi), _, n_real = self._local_rows
            idx = np.arange(hi - lo) % b
            arrays = tuple(np.asarray(a)[idx] for a in arrays)
            weights = np.zeros(hi - lo, np.float32)
            weights[:n_real] = 1.0
        else:
            arrays, weights = pad_batch(arrays, world)
            (lo, hi), _ = local_batch_rows(world, rank(self.group), b)
            arrays = tuple(np.asarray(a)[lo:hi] for a in arrays)
            weights = weights[lo:hi]
        local = dict(batch, **dict(zip(keys, arrays)), weights=weights)
        return batch_tensors(local, self.device), len(weights) * world

    def _dump_train_trace(self, images, lobes, step_idx, transform_state,
                          max_samples=2):
        """Dense and refined CAM tiles of the training batch's first
        samples, from an eval forward (TRACE); for an equivariance loss
        also the transformed image's tiles and the drawn transform
        (dram_tpu/train/trainer.py:787-829), redrawn from the step's
        transform generator state `transform_state`."""
        trace_dir = os.path.join(self.debug_path, "train_trace",
                                 f"{self.epoch_n}_{step_idx}")
        os.makedirs(trace_dir, exist_ok=True)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                dense, refined = self.model(images[:max_samples])
        finally:
            self.model.train(was_training)
        d_np = dense[..., 0].float().cpu().numpy()
        r_np = refined[..., 0].float().cpu().numpy()
        im_np = images[:max_samples, ..., 0].float().cpu().numpy()
        lo_np = lobes[:max_samples, ..., 0].cpu().numpy() > 0
        for i in range(d_np.shape[0]):
            draw_mask_tile_singleview_heatmap(
                windowing_np(im_np[i], from_span=(0, 1)).astype(np.uint8),
                [[(windowing_np(d_np[i], from_span=None) *
                   lo_np[i]).astype(np.uint8)],
                 [(windowing_np(r_np[i], from_span=None) *
                   lo_np[i]).astype(np.uint8)]],
                r_np[i] > 0, 5, os.path.join(trace_dir, f"sample_{i}"),
                titles=["dram", "dram_refine"])
        if hasattr(self.loss_func, "_transform"):
            gen = torch.Generator()
            gen.set_state(transform_state)
            T = self.loss_func._transform(gen, images.shape[1:4])
            aff = T(images[:max_samples]).float().cpu().numpy()[..., 0]
            for i in range(aff.shape[0]):
                draw_mask_tile_singleview_heatmap(
                    windowing_np(aff[i], from_span=(0, 1)).astype(np.uint8),
                    [[np.zeros_like(aff[i], np.uint8)]], aff[i] > -1e8, 5,
                    os.path.join(trace_dir, f"sample_{i}_transformed"),
                    titles=["transformed"])
            with open(os.path.join(trace_dir, "transform.txt"), "wt") as fp:
                fp.write(f"{T!r}\n")

    def _start_profile(self):
        """A started torch.profiler over this epoch's steps when
        PROFILE_DIR is set and the epoch is PROFILE_EPOCH (default 1),
        else None: CPU activity, and CUDA's on the card."""
        s = self.settings
        if not getattr(s, "PROFILE_DIR", None) or \
                self.epoch_n != getattr(s, "PROFILE_EPOCH", 1):
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        """Stop `prof` (the card synchronised first) and write its Chrome
        trace, PROFILE_DIR/epoch_<n>_rank_<r>.trace.json; returns the
        path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.settings.PROFILE_DIR
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"epoch_{self.epoch_n}_rank_{rank()}"
                                 ".trace.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profile of epoch {self.epoch_n} -> {path}")
        return path

    def train(self):
        """One epoch of steps. Returns tr_loss (the sample-weighted mean
        loss), tr_data_time and tr_batch_time (s a step); `epoch_stats`
        also holds the steps, each step's loss, their wall seconds and the
        peak device MiB, and the trace's path when the epoch is profiled
        (PROFILE_DIR, PROFILE_EPOCH)."""
        s = self.settings
        batch_time, data_time, loss_record = \
            AverageMeter(), AverageMeter(), AverageMeter()
        freq = torch.from_numpy(np.asarray(self.ctss_frequency_array,
                                           np.float32)).to(self.device)
        trace_on = bool(getattr(s, "TRACE", False))
        trace_steps = getattr(s, "TRACE_STEPS", 0)
        seed = int(getattr(s, "RANDOM_SEED", 33))
        peak = 0.0 if self.device.type == "cuda" else None
        prof = self._start_profile()
        t_start = time.time()
        end = time.time()
        pending = None  # the previous step's (loss, losses, batch size)
        losses = []
        for step_idx, batch in enumerate(self.tr_loader):
            data_time.update(time.time() - end)
            args, n_rows = self._device_batch(batch)
            args["freq"] = freq
            if hasattr(self.loss_func, "epoch_reseed"):
                self.loss_func.epoch_reseed(
                    seed + 7919 * self.epoch_n + 104729 * step_idx)
            self.scheduler.apply(self.optimizer)
            transform_state = self.train_step.transform_gen.get_state()
            out = self.train_step(**args, timed=False)
            self.current_iteration += 1
            if peak is not None:
                peak = max(peak, out["peak_mib"])
            if trace_on and self.writer and (step_idx == 0 or (
                    trace_steps and step_idx % trace_steps == 0)):
                try:
                    self._dump_train_trace(
                        unpack_image_wire(args["images"], args["span"]),
                        args["lobes"], step_idx, transform_state)
                except Exception as e:
                    self.logger.warning(f"train trace failed: {e}")
            if pending is not None:
                losses.append(float(pending[0]))
                loss_record.update(losses[-1], pending[2])
            pending = (out["loss"], out["losses"], n_rows)
            batch_time.update(time.time() - end)
            end = time.time()
            if self.current_iteration % s.LOG_STEPS == 0:
                # reads this step's loss: the one wait for the card
                cur = float(pending[0])
                avg = (loss_record.sum + cur * pending[2]) / \
                    max(loss_record.count + pending[2], 1)
                lv = [f"{float(l):.5f}" for l in pending[1]]
                self.logger.info(
                    f"Epoch: [{self.epoch_n}][{step_idx}], "
                    f"Time {batch_time.val:.3f} ({data_time.avg:.3f}) "
                    f"Loss {cur:.6f} ({avg:.6f}), losses: {lv}")
        if pending is not None:
            losses.append(float(pending[0]))
            loss_record.update(losses[-1], pending[2])
        self.epoch_stats = {"steps": batch_time.count, "losses": losses,
                            "seconds": time.time() - t_start,
                            "peak_mib": peak}
        if prof is not None:
            self.epoch_stats["trace"] = self._stop_profile(prof)
        return {"tr_loss": loss_record.avg, "tr_data_time": data_time.avg,
                "tr_batch_time": batch_time.avg}

    # -- validation ----------------------------------------------------
    def _val_pipeline(self):
        """The inference pipeline over the live model (no weight copy)."""
        if self._val_pipe is None:
            s = self.settings
            self._val_pipe = FastScanPipeline(
                self.model, device=self.device,
                chunk_size=tuple(s.RESAMPLE_SIZE),
                windowing_span=(s.WINDOWING_MIN, s.WINDOWING_MAX),
                pad_value=float(s.PAD_VALUE))
        return self._val_pipe

    def _target(self, meta):
        return int(float(meta["cle"])) if "cle" in meta else \
            int(float(meta["patient_meta"]["cle"]))

    def evaluate_scan(self, scan_data):
        """(predicted ordinal class, target, seconds) of one validation
        scan: the chunk wire's prep and process_chunks_val, or the
        host-stitch loop with VAL_USE_FAST_PIPELINE = False or TRACE. The
        prep and forward ms go to `val_timings`."""
        if self.trace or not getattr(self.settings, "VAL_USE_FAST_PIPELINE",
                                     True):
            return self._evaluate_scan_hoststitch(scan_data)
        s = self.settings
        meta = scan_data["meta"]
        now = time.time()
        pipe = self._val_pipeline()
        prep = prep_scan_chunks(
            np.asarray(scan_data["#image"], np.int16),
            np.asarray(scan_data["#lobe_reference"], np.uint8),
            meta["spacing"], pad_value=s.PAD_VALUE,
            windowing_span=(s.WINDOWING_MIN, s.WINDOWING_MAX),
            chunk_size=tuple(s.RESAMPLE_SIZE), crop_border_mm=5.0)
        t_prep = time.time()
        pred_ratio = pipe.process_chunks_val(prep)
        t_val = time.time()
        self.val_timings.append({"uid": meta.get("uid"),
                                 "prep_ms": (t_prep - now) * 1e3,
                                 "val_ms": (t_val - t_prep) * 1e3,
                                 "ratio": pred_ratio})
        reg_cls_pred = ratio_to_label([pred_ratio])[0]
        target = self._target(meta)
        self.logger.info(f"val scan {meta.get('uid')}: reg_cls_pred "
                         f"{reg_cls_pred}, target {target}")
        return reg_cls_pred, target, t_val - now

    def _evaluate_scan_hoststitch(self, scan_data):
        """Each lobe alone: cropped with a 5 mm border, masked, windowed and
        resized to the chunk on the host, one batch-1 forward, the refined
        head's sigmoid resized back and stitched under the lobe; the scan's
        ratio is its mean within the lung."""
        s = self.settings
        scan = scan_data["#image"]
        lobe = scan_data["#lobe_reference"]
        meta = scan_data["meta"]
        now = time.time()
        pre = T.Compose(self.preprocessing())
        htp = np.zeros(scan.shape, np.float32)
        epoch_debug_path = os.path.join(self.debug_path, str(self.epoch_n))
        for lobe_label in np.unique(lobe)[1:]:
            lobe_binary = lobe == lobe_label
            crop = find_crops_np(lobe_binary, meta["spacing"], 5)
            lobe_chunk = lobe_binary[crop]
            scan_chunk = scan[crop].copy()
            crop_size = lobe_chunk.shape
            scan_chunk[lobe_chunk == 0] = s.PAD_VALUE
            ret = pre({"#image": scan_chunk.astype(np.int16),
                       "#lobe_reference": lobe_chunk.astype(np.uint8),
                       "meta": {"size": scan_chunk.shape,
                                "spacing": meta["spacing"]}})
            if self.trace:
                v_lobe = np.asarray(ret["#lobe_reference"])
                draw_mask_tile_single_view(
                    windowing_np(np.asarray(ret["#image"], np.float32),
                                 from_span=(0, 1)),
                    [[(v_lobe > 0).astype(np.uint8)]], v_lobe > 0, 5,
                    os.path.join(epoch_debug_path,
                                 f"{meta['uid']}_{lobe_label}"),
                    colors=[(0, 0, 255)], thickness=[-1], coord_axis=0,
                    alpha=0.3, titles=["lobe"])
            image = torch.from_numpy(np.ascontiguousarray(
                ret["#image"][None, ..., None], np.float32)).to(self.device)
            _, refined = self.model(image)
            probs = torch.sigmoid(refined)[0, ..., 0].float().cpu().numpy()
            probs = resize3d_np(probs, crop_size, "trilinear")
            mask = lobe_chunk > 0
            htp[crop][mask] = probs[mask]
        lung = lobe > 0
        pred_ratio = float((htp * lung).sum() / max(lung.sum(), 1))
        reg_cls_pred = ratio_to_label([pred_ratio])[0]
        target = self._target(meta)
        self.val_timings.append({"uid": meta.get("uid"),
                                 "hoststitch_ms": (time.time() - now) * 1e3,
                                 "ratio": pred_ratio})
        self.logger.info(f"val scan {meta.get('uid')}: reg_cls_pred "
                         f"{reg_cls_pred}, target {target}")
        return reg_cls_pred, target, time.time() - now

    def validate(self):
        """Every validation scan in eval mode without grad (the mode found
        is restored after): val_time (s a scan) and val_acc_reg_cls; the
        confusion matrix under debug_path/<epoch>/. On N ranks rank 0
        validates and every rank returns its result (and its
        val_timings)."""
        v = timings = None
        if self.writer:
            v = self._validate()
            timings = self.val_timings
        v, self.val_timings = broadcast_object((v, timings), self.group)
        return v

    def _validate(self):
        self.logger.info(f"validating {len(self.val_dataset)} scans at epoch "
                         f"{self.epoch_n}")
        val_time = AverageMeter()
        preds, targets = [], []
        self.val_timings = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for i in range(len(self.val_dataset)):
                    p, t, dt = self.evaluate_scan(self.val_dataset[i])
                    preds.append(p)
                    targets.append(t)
                    val_time.update(dt, 1)
        finally:
            self.model.train(was_training)
        epoch_debug = os.path.join(self.debug_path, str(self.epoch_n)) + "/"
        os.makedirs(epoch_debug, exist_ok=True)
        acc = float(np.mean(np.asarray(preds) == np.asarray(targets)))
        try:
            plot_confusion_matrix_from_data(
                targets, preds, labels=list(range(6)),
                save_path=epoch_debug + "cm_reg_cls")
        except Exception as e:
            self.logger.warning(f"confusion-matrix plot failed: {e}")
        v = {"val_time": val_time.avg, "val_acc_reg_cls": acc}
        self.logger.info(f"val_metrics: {v}")
        return v

    # -- epochs ----------------------------------------------------------
    def run(self):
        s = self.settings
        self.logger.info(f"running epochs {self.epoch_n}..{s.NUM_EPOCHS}")
        for epoch_n in range(self.epoch_n, s.NUM_EPOCHS):
            self.epoch_n = epoch_n
            self.reset_data()
            tr_metrics = self.train()
            entry = {"epoch": epoch_n, **self.epoch_stats, **tr_metrics}
            self.history.append(entry)
            if (epoch_n % s.VAL_EPOCHS == 0 or epoch_n == s.NUM_EPOCHS - 1
                    or epoch_n < 15):
                val_metrics = self.validate()
                entry["val_scans"] = list(self.val_timings)
                self.model_metrics_save_dict.update(val_metrics)
                self.model_metrics_save_dict.update(tr_metrics)
                self.summary_writer.add_scalars("val_metrics", val_metrics,
                                                global_step=epoch_n)
                self.summary_writer.add_scalars("tr_metrics", tr_metrics,
                                                global_step=epoch_n)
                row = {"epoch": epoch_n,
                       "iteration": self.current_iteration,
                       "learning_rate": self.scheduler.lr}
                row.update(self.model_metrics_save_dict)
                self.train_records.append(row)
                if self.writer:
                    write_records(self.exp_path + "/records.csv",
                                  self.train_records, "epoch")
                self.scheduler.step()
                self.scheduler.apply(self.optimizer)
            ple = int(getattr(s, "PARAM_LOG_EPOCHS", 0) or 0)
            if ple > 0 and epoch_n % ple == 0:
                self.print_model_parameters(self.current_iteration)
            if epoch_n % s.STATE_EPOCHS == 0 or epoch_n == s.NUM_EPOCHS - 1:
                t0 = time.perf_counter()
                self.save_model()
                entry["save_ms"] = (time.perf_counter() - t0) * 1e3
        self.logger.info(f"Training stops at epoch {self.epoch_n}.")
