"""MultiHeadTrainer, the base continual-learning trainer: the port of
``lifelong_nnunet_tpu/training/trainer.py``.

It owns the U-Net (or, with ``use_vit``, the ViT-U-Net of
``models/vit_unet.py`` at half the plans' batch, as the JAX trainer halves
it) on one explicit device, the multi-head registry, each task's data
split, the per-task epoch loop (``iters_per_epoch`` train steps, then
``val_iters`` validation batches; ``train_task(..., start_epoch)``
continues an interrupted task), the checkpoints ``before_training`` /
``model_best`` / ``model_latest`` / ``model_final_checkpoint`` with the
registry and the optimizer (``load_checkpoint`` restores them), the
``<extension>_trained_on.json`` manifest and the cross-task validation
``_perform_validation`` (sliding window per subject, or the reference's
patch-sampled validation) into ``val_metrics.json`` / ``.csv``.  The
recipe is the JAX package's: 250/50 train/val iterations per epoch, poly LR
from 0.01 on a fresh optimizer per task, SGD Nesterov 0.99, clip 12, deep
supervision, moreDA augmentation on the device, bf16 activations on the
card with f32 parameters.  Every task is trained with the first task's
plans, patch and pools, and ``best_val`` runs on across tasks, as in the
JAX trainer.

Continual-learning methods subclass it and override the hooks
(``init_cl_state`` / ``loss_extras`` / ``cl_state_update`` /
``before_task`` / ``after_task`` / ``trainable_mask`` /
``extra_manifest`` / ``_adopt_manifest``) and ``HYPERPARAMS``.  Their
``cl_state`` rides in every checkpoint; ``trainable_mask`` ({key: bool})
reaches the optimizer, which leaves the frozen parameters as they are.

Not ported yet, and refused by ``run/run_training.py`` when asked for:
task-specific LayerNorms, SPMD (``-n_devices`` / ``-model_parallel``) and
rematerialization; their options are not fields of :class:`TrainerOptions`
(nor is the profiler's).  In place of the JAX package's ``progress.png``
(matplotlib is not a dependency of the port), ``progress.json`` beside the
checkpoints holds the epoch curves and every train step's loss.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data.augment import AugmentConfig
from ..data.dataset import PreprocessedDataset, final_splits
from ..data.pipeline import Prefetcher
from ..data.sampler import PatchSampler
from ..device import resolve_device
from ..evaluation.metrics import subject_metrics
from ..inference.sliding_window import predict_sliding_window
from ..models.multihead import MultiHeadParams
from ..models.unet import ds_scale_factors, unet_from_plans
from ..models.vit_unet import vit_overrides, vit_unet_from_plans
from ..utilities.logging_utils import RunLogger
from . import checkpoints
from .restore import route_switches
from .optimizer import PolySGD
from .train_step import StepConfig, make_eval_step, make_train_step

# the JAX package's recipe values, which no caller of the port changes
INITIAL_LR = 1e-2
OVERSAMPLE_FOREGROUND = 0.33
SEED = 0


@dataclass
class TrainerOptions:
    num_epochs: int = 1000
    iters_per_epoch: int = 250
    val_iters: int = 50
    save_every: int = 25
    split_at: str = "seg_outputs"
    batch_size: int | None = None          # None -> plans value
    patch_size: tuple | None = None        # None -> plans value
    dtype: str = "bfloat16"                # activations on the card
    augment: bool = True
    fold: int = 0
    base_num_features: int | None = None   # None -> plans value
    max_num_features: int | None = None
    device: str = "cuda"
    use_kernels: bool = True               # False: the plain route
    use_progress_val: bool = False         # _perform_validation every save_every
    # "sliding_window" (per-subject metrics on whole volumes) or "patches"
    # (the reference's patch-sampled periodic validation)
    val_mode: str = "sliding_window"
    # the ViT-U-Net backbone (models/vit_unet.py)
    use_vit: bool = False
    vit_version: str = "V1"
    vit_type: str = "base"
    vit_lsa: bool = False
    vit_spt: bool = False
    vit_depth_override: int | None = None  # depth d, embed max(16, 8 d), 2 heads


class MultiHeadTrainer:
    EXTENSION = "multihead"
    HYPERPARAMS: dict = {}
    # Sequential-style trainers transfer the previous head to new tasks
    TRANSFER_HEADS = False

    def __init__(self, plans, config_name: str, output_folder: str,
                 options: TrainerOptions | None = None, **hyperparams):
        self.opts = options or TrainerOptions()
        self.plans = plans
        self.config_name = config_name
        self.cfg = plans.config(config_name)
        self.output_folder = output_folder
        self.hyperparams = hyperparams
        self.num_classes = plans.num_classes + 1
        # nnU-Net's batch-dice rule: 2d and 3d_fullres pool over the batch
        self.batch_dice = config_name in ("2d", "3d_fullres")
        self.device = resolve_device(self.opts.device)
        dtype = torch.bfloat16 if self.opts.dtype == "bfloat16" \
            and self.device.type == "cuda" else torch.float32
        self.patch_size = tuple(self.opts.patch_size or self.cfg.patch_size)
        self.batch_size = int(self.opts.batch_size or self.cfg.batch_size)
        # the CT-scale routes' switches, read where the JAX trainer reads them
        # (trainer.py:151-156, LNN_UPT_MODE through its model)
        widths = dict(dtype=dtype, use_kernels=self.opts.use_kernels,
                      generator=torch.Generator().manual_seed(SEED),
                      base_num_features=self.opts.base_num_features,
                      max_num_features=self.opts.max_num_features, **route_switches())
        if self.opts.use_vit:
            self.model = vit_unet_from_plans(
                plans, config_name, self.patch_size, vit_version=self.opts.vit_version,
                vit_type=self.opts.vit_type, lsa=self.opts.vit_lsa, spt=self.opts.vit_spt,
                **widths, **vit_overrides(self.opts.vit_depth_override))
            # the ViT's batch halving (reference multihead trainer :283-292)
            self.batch_size = max(1, self.batch_size // 2)
        else:
            self.model = unet_from_plans(plans, config_name, **widths)
        self.model = self.model.to(self.device)
        self.ds_factors = tuple(ds_scale_factors(self.cfg.pool_op_kernel_sizes))
        self.mh: MultiHeadParams | None = None
        self.cl_state = self.init_cl_state()
        self.optimizer: PolySGD | None = None
        self._train_step = None
        self._eval_step = None
        self.epoch = 0
        self.global_step = 0
        self.best_val = math.inf
        self.already_trained_on: dict = {}
        self.metadata_folder = output_folder
        self.logger = RunLogger(output_folder)
        self.generator = torch.Generator(device=self.device).manual_seed(SEED)
        self._datasets: dict = {}     # task -> (PreprocessedDataset, tr_cases, val_cases)
        self._epoch_log: list = []    # dicts: task, epoch, tr_loss, val_loss, val_dice
        self.step_losses: list = []   # per train step, floats, in order
        self._val_history: list = []
        # the optimizer state of a restored checkpoint, adopted by the next
        # _build_step (a resumed task continues its momentum and LR count)
        self._resume_opt: dict | None = None

    # ------------------------------------------------------------------ hooks
    def init_cl_state(self):
        return {}

    def loss_extras(self):
        return None

    def cl_state_update(self):
        return None

    def before_task(self, task: str):
        pass

    def after_task(self, task: str):
        pass

    def trainable_mask(self):
        """Override for the freezing methods; None = everything trainable."""
        return None

    def extra_manifest(self) -> dict:
        """Per-trainer additions to the checkpoint manifest."""
        return {}

    def _adopt_manifest(self, manifest: dict):
        """Adopt trainer-specific manifest fields in ``load_checkpoint``,
        before the train step is rebuilt."""

    # -------------------------------------------------------------- data
    def register_task_data(self, task: str, stage_dir: str):
        ds = PreprocessedDataset(stage_dir)
        fold = self.opts.fold
        if fold == -1 or fold == "all":
            tr, val = list(ds.cases), list(ds.cases)
        else:
            # splits_final.json in the task dir (user-editable); computed by
            # kfold_split on first use
            splits = final_splits(os.path.dirname(stage_dir), ds.cases)
            s = splits[fold % len(splits)]
            tr, val = list(s["train"]), list(s["val"])
        self._datasets[task] = (ds, tr, val)
        return tr, val

    def _make_sampler(self, task: str, train: bool = True, seed_offset: int = 0):
        ds, tr, val = self._datasets[task]
        return PatchSampler(ds, tr if train else val, self.patch_size, self.batch_size,
                            oversample_foreground_percent=OVERSAMPLE_FOREGROUND,
                            seed=SEED + seed_offset + (0 if train else 1000))

    # -------------------------------------------------------------- setup
    def _ensure_initialized(self, task: str):
        if self.mh is not None:
            return
        self.mh = MultiHeadParams.create(self.model.state_dict(), self.opts.split_at,
                                         self.model.module_order(), task)
        n = sum(p.numel() for p in self.model.parameters())
        self.logger(f"initialized network: {n:,} params, patch {self.patch_size}, "
                    f"batch {self.batch_size}, {self.model.dtype} on {self.device}")

    def _build_step(self):
        """A fresh optimizer (over the parameters that ``trainable_mask``
        leaves trainable) and the train and eval steps, with the hooks'
        terms as they stand now (``before_task`` runs first)."""
        self.model.load_state_dict(self.mh.assemble())
        self.optimizer = PolySGD(self.model.named_parameters(),
                                 max_epochs=self.opts.num_epochs,
                                 iters_per_epoch=self.opts.iters_per_epoch,
                                 initial_lr=INITIAL_LR, trainable_mask=self.trainable_mask())
        aug = AugmentConfig(dummy_2d=bool(getattr(self.cfg, "do_dummy_2d_aug", False))) \
            if self.opts.augment else None
        step_cfg = StepConfig(ds_factors=self.ds_factors, batch_dice=self.batch_dice,
                              num_classes=self.num_classes, augment=aug)
        self._train_step = make_train_step(self.model, self.optimizer, step_cfg,
                                           loss_extras=self.loss_extras(),
                                           cl_state_update=self.cl_state_update(),
                                           generator=self.generator)
        self._eval_step = make_eval_step(self.model, step_cfg)
        if self._resume_opt is not None:
            self.optimizer.load_state_dict(self._resume_opt)
            self._resume_opt = None

    # -------------------------------------------------------------- manifest
    def set_output_folder(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        self.output_folder = folder
        self.logger = RunLogger(folder)

    def _trained_on_path(self) -> str:
        os.makedirs(self.metadata_folder, exist_ok=True)
        return os.path.join(self.metadata_folder, f"{self.EXTENSION}_trained_on.json")

    def _update_manifest(self, **kv):
        self.already_trained_on.setdefault(str(self.opts.fold), {
            "finished_training_on": [], "start_training_on": None,
            "finished_validation_on": [], "prev_trainer": [],
            "used_identifier": self.plans.plans_name,
            "checkpoint_should_exist": False,
            "tasks_at_time_of_checkpoint": [],
            "active_task_at_time_of_checkpoint": None,
            "hyperparams": {k: str(v) for k, v in self.hyperparams.items()},
        })
        self.already_trained_on[str(self.opts.fold)].update(kv)
        with open(self._trained_on_path(), "w") as f:
            json.dump(self.already_trained_on, f, indent=2)

    # -------------------------------------------------------------- training
    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None,
                   start_epoch: int = 0):
        """Train on one task: register its data, add (from ``state_init``,
        or from the active head for ``TRANSFER_HEADS``) or activate its
        head, run the epoch loop with its checkpoints, update the manifest.
        ``start_epoch`` continues an interrupted task from a restored
        ``model_latest``; its ``before_training`` checkpoint stays as it
        was."""
        num_epochs = num_epochs or self.opts.num_epochs
        self.register_task_data(task, stage_dir)
        self._ensure_initialized(task)
        self.mh = self.mh.add_new_task(task, use_init=not self.TRANSFER_HEADS)
        self.before_task(task)
        self._build_step()
        self._update_manifest(start_training_on=task, checkpoint_should_exist=False)
        if not start_epoch:
            self.save_checkpoint("before_training")
        seed_offset = len(self.mh.tasks)
        prefetch = Prefetcher(self._make_sampler(task, True, seed_offset), self.device)
        val_sampler = self._make_sampler(task, False, seed_offset)
        try:
            for epoch in range(start_epoch, num_epochs):
                self.epoch = epoch
                t0 = time.time()
                self.model.train()
                losses = []
                for _ in range(self.opts.iters_per_epoch):
                    batch, _keys = prefetch.next()
                    self.cl_state, metrics = self._train_step(self.cl_state, batch)
                    losses.append(metrics["loss"])
                    self.global_step += 1
                losses = torch.stack(losses).float().cpu()
                self.step_losses += losses.tolist()
                tr_loss = float(losses.mean())
                val_loss, val_dice = self._quick_val(val_sampler)
                self.logger(f"[{task}] epoch {epoch}: train {tr_loss:.4f} "
                            f"val {val_loss:.4f} fg-dice {val_dice:.4f} "
                            f"({time.time() - t0:.1f}s)")
                self._epoch_log.append({"task": task, "epoch": epoch, "tr_loss": tr_loss,
                                        "val_loss": val_loss, "val_dice": val_dice})
                self.mh = self.mh.absorb(self.model.state_dict(), task)
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    self.save_checkpoint("model_best")
                if (epoch + 1) % self.opts.save_every == 0 or epoch == num_epochs - 1:
                    self.save_checkpoint("model_latest")
                    self._write_progress()
                    self._update_manifest(checkpoint_should_exist=True,
                                          tasks_at_time_of_checkpoint=self.mh.tasks,
                                          active_task_at_time_of_checkpoint=task)
                    if self.opts.use_progress_val:
                        self._perform_validation(tag=f"epoch_{epoch}")
        finally:
            prefetch.stop()
        self.mh = self.mh.absorb(self.model.state_dict(), task)
        self.after_task(task)
        self.save_checkpoint("model_final_checkpoint")
        fold_state = self.already_trained_on.get(str(self.opts.fold), {})
        self._update_manifest(
            finished_training_on=fold_state.get("finished_training_on", []) + [task],
            start_training_on=None,
            finished_validation_on=fold_state.get("finished_validation_on", []) + [task],
            checkpoint_should_exist=True, tasks_at_time_of_checkpoint=self.mh.tasks,
            active_task_at_time_of_checkpoint=task)

    def _quick_val(self, val_sampler):
        """Mean loss and foreground Dice over ``val_iters`` unaugmented
        validation batches."""
        self.model.eval()
        losses, tp, fp, fn = [], 0, 0, 0
        for _ in range(self.opts.val_iters):
            b = val_sampler.next_batch()
            m = self._eval_step({k: torch.from_numpy(b[k]).to(self.device)
                                 for k in ("data", "seg")})
            losses.append(m["loss"])
            tp, fp, fn = tp + m["tp"], fp + m["fp"], fn + m["fn"]
        dice = (2 * tp / torch.clamp(2 * tp + fp + fn, min=1)).float().mean()
        return float(torch.stack(losses).mean()), float(dice)

    def _write_progress(self):
        with open(os.path.join(self.output_folder, "progress.json"), "w") as f:
            json.dump({"epochs": self._epoch_log, "step_losses": self.step_losses}, f)

    # -------------------------------------------------------------- validation
    def _perform_validation(self, tasks: list | None = None, use_head: str | None = None,
                            always_use_last_head: bool = False, tag: str = "",
                            call_for_eval: bool = False,
                            mirror_axes: tuple | None = None) -> dict:
        """Cross-task per-subject Dice/IoU: for every registered task (or
        ``tasks``), its validation cases with its own head (or ``use_head``,
        or the last head), by sliding window (window batch 4, no mirroring
        unless ``call_for_eval``) or, with ``val_mode`` ``patches``, by
        :meth:`_patch_validation`; written to ``val_metrics.json`` / ``.csv``
        (``val_metrics_eval.*`` for ``call_for_eval``).  The trained
        parameters are back in the model afterwards."""
        if mirror_axes is None:
            mirror_axes = (0, 1, 2) if call_for_eval else ()
        mirror_axes = tuple(a for a in mirror_axes if a < len(self.patch_size))
        trained = {k: v.clone() for k, v in self.model.state_dict().items()}
        self.model.eval()
        results = {}
        try:
            for t in tasks or list(self._datasets):
                ds, _tr, val = self._datasets[t]
                head = use_head or (self.mh.tasks[-1] if always_use_last_head else t)
                if head not in self.mh.tasks:
                    head = self.mh.tasks[-1]
                self.model.load_state_dict(self.mh.assemble(head))
                if self.opts.val_mode == "patches" and not call_for_eval:
                    results[t] = {"head": head, "subjects": self._patch_validation(ds, val)}
                    continue
                subjects = {}
                for case in val:
                    arr = np.asarray(ds.load(case))
                    probs = predict_sliding_window(
                        self.model, np.moveaxis(arr[:-1], 0, -1), self.patch_size,
                        self.num_classes, device=self.device, mirror_axes=mirror_axes,
                        window_batch=4)
                    subjects[case] = subject_metrics(np.argmax(probs, axis=-1),
                                                     arr[-1].astype(np.int32),
                                                     self.num_classes)
                results[t] = {"head": head, "subjects": subjects}
        finally:
            self.model.load_state_dict(trained)
        out = {"epoch": self.epoch, "tag": tag, "results": results}
        self._val_history.append(out)
        path = os.path.join(self.output_folder,
                            "val_metrics_eval.json" if call_for_eval else "val_metrics.json")
        hist = [out] if call_for_eval else self._val_history
        with open(path, "w") as f:
            json.dump(hist, f, indent=2)
        self._write_val_csv(path.replace(".json", ".csv"), hist)
        return results

    def _patch_validation(self, ds, val_cases) -> dict:
        """The reference's patch-sampled validation: ``val_iters`` batches
        of foreground-oversampled patches of the validation cases (sampler
        seed ``SEED + 4242``, no augmentation), hard tp/fp/fn summed per
        subject over the draws, per-subject Dice/IoU."""
        sampler = PatchSampler(ds, val_cases, self.patch_size, self.batch_size,
                               oversample_foreground_percent=OVERSAMPLE_FOREGROUND,
                               seed=SEED + 4242)
        acc: dict = {}
        for _ in range(self.opts.val_iters):
            b = sampler.next_batch()
            with torch.no_grad():
                pred = self.model(torch.from_numpy(b["data"]).to(self.device))[0].argmax(1)
            seg = torch.from_numpy(b["seg"]).to(self.device).long()
            valid, dims = seg >= 0, tuple(range(1, seg.dim()))
            per = []
            for c in range(1, self.num_classes):
                hit, lab = (pred == c) & valid, (seg == c) & valid
                per.append(torch.stack([(hit & lab).sum(dims), (hit & ~lab).sum(dims),
                                        (~hit & lab).sum(dims)], -1))
            for key, row in zip(b["keys"], torch.stack(per, 1).cpu().numpy()):
                acc[key] = acc.get(key, 0) + row
        out = {}
        for case, row in acc.items():
            tp, fp, fn = row[:, 0], row[:, 1], row[:, 2]
            out[case] = {"dice": (2 * tp / np.maximum(2 * tp + fp + fn, 1)).tolist(),
                         "iou": (tp / np.maximum(tp + fp + fn, 1)).tolist()}
        return out

    @staticmethod
    def _write_val_csv(path: str, history: list):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "tag", "task", "head", "subject", "metric", "class", "value"])
            for entry in history:
                for task, r in entry["results"].items():
                    for subj, metrics in r["subjects"].items():
                        for metric, vals in metrics.items():
                            for ci, v in enumerate(vals):
                                w.writerow([entry["epoch"], entry["tag"], task,
                                            r["head"], subj, metric, ci + 1, v])

    # -------------------------------------------------------------- checkpoints
    def manifest(self) -> dict:
        o = self.opts
        vit = checkpoints.vit_manifest(o.vit_version, o.vit_type, o.vit_lsa, o.vit_spt,
                                       o.vit_depth_override) if o.use_vit else None
        man = checkpoints.base_manifest(self.plans, self.config_name, self.model,
                                        trainer=type(self).__name__,
                                        extension=self.EXTENSION, fold=o.fold, vit=vit)
        man.update(patch_size=list(self.patch_size), batch_size=self.batch_size,
                   split_at=o.split_at, transfer_heads=self.TRANSFER_HEADS,
                   hyperparams={k: str(v) for k, v in self.hyperparams.items()})
        man.update(self.extra_manifest())
        return man

    def save_checkpoint(self, name: str):
        # trainers whose new heads copy the active head never read
        # state_init: it is left out, as in the JAX package
        checkpoints.save_registry(
            os.path.join(self.output_folder, name), self.mh, self.manifest(),
            optimizer=self.optimizer.state_dict() if self.optimizer else None,
            step=self.global_step, epoch=self.epoch,
            include_state_init=not self.TRANSFER_HEADS, cl_state=self.cl_state)

    def load_checkpoint(self, name: str = "model_final_checkpoint",
                        restore_opt: bool = True) -> dict:
        """Restore the registry, epoch, global step and ``cl_state`` (on the
        trainer's device; a checkpoint without one keeps the fresh
        ``init_cl_state``) of ``name`` in the output folder, and with
        ``restore_opt`` the optimizer (momentum and step count), kept for
        the ``_build_step`` of a following ``train_task(..., start_epoch)``.
        Returns the manifest."""
        mh, blob, manifest = checkpoints.load_registry(
            os.path.join(self.output_folder, name), self.device, self.model.module_order())
        self.mh = mh
        self.epoch = manifest["epoch"]
        self.global_step = manifest["step"]
        self._adopt_manifest(manifest)
        if manifest.get("has_cl_state") and blob.get("cl_state") is not None:
            self.cl_state = blob["cl_state"]
        self._build_step()
        if restore_opt and manifest.get("has_opt_state"):
            self.optimizer.load_state_dict(blob["optimizer"])
            self._resume_opt = blob["optimizer"]
        return manifest
