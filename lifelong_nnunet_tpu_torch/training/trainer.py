"""MultiHeadTrainer, the single-task path: the port of
``lifelong_nnunet_tpu/training/trainer.py``.

It owns the U-Net (or, with ``use_vit``, the ViT-U-Net of
``models/vit_unet.py`` at half the plans' batch, as the JAX trainer halves
it) on one explicit device, the multi-head registry, the
task's data split, the epoch loop (``iters_per_epoch`` train steps, then
``val_iters`` validation batches), the checkpoints ``model_best`` /
``model_latest`` / ``model_final_checkpoint`` and the
``<extension>_trained_on.json`` manifest.  The recipe is the JAX
package's: 250/50 train/val iterations per epoch, poly LR from 0.01, SGD
Nesterov 0.99, clip 12, deep supervision, moreDA augmentation on the
device, bf16 activations on the card with f32 parameters.

Not ported yet, and refused by ``run/run_training.py`` when asked for:
task-specific LayerNorms, SPMD (``-n_devices`` / ``-model_parallel``), rematerialization,
patch-sampled and sliding-window progress validation
(``_perform_validation``), and resuming a task (``-c``); their options are
not fields of :class:`TrainerOptions` (nor is the profiler's).  In place of the
JAX package's ``progress.png`` (matplotlib is not a dependency of the
port), ``progress.json`` beside the checkpoints holds the epoch curves and
every train step's loss.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass

import torch

from ..data.augment import AugmentConfig
from ..data.dataset import PreprocessedDataset, final_splits
from ..data.pipeline import Prefetcher
from ..data.sampler import PatchSampler
from ..device import resolve_device
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
    # the ViT-U-Net backbone (models/vit_unet.py)
    use_vit: bool = False
    vit_version: str = "V1"
    vit_type: str = "base"
    vit_lsa: bool = False
    vit_spt: bool = False
    vit_depth_override: int | None = None  # depth d, embed max(16, 8 d), 2 heads


class MultiHeadTrainer:
    EXTENSION = "multihead"
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
        self.model.load_state_dict(self.mh.assemble())
        self.optimizer = PolySGD(self.model.parameters(), max_epochs=self.opts.num_epochs,
                                 iters_per_epoch=self.opts.iters_per_epoch,
                                 initial_lr=INITIAL_LR)
        aug = AugmentConfig(dummy_2d=bool(getattr(self.cfg, "do_dummy_2d_aug", False))) \
            if self.opts.augment else None
        step_cfg = StepConfig(ds_factors=self.ds_factors, batch_dice=self.batch_dice,
                              num_classes=self.num_classes, augment=aug)
        self._train_step = make_train_step(self.model, self.optimizer, step_cfg,
                                           loss_extras=self.loss_extras(),
                                           cl_state_update=self.cl_state_update(),
                                           generator=self.generator)
        self._eval_step = make_eval_step(self.model, step_cfg)

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
    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None):
        """Train on one task: register its data, add or activate its head,
        run the epoch loop with its checkpoints, update the manifest."""
        num_epochs = num_epochs or self.opts.num_epochs
        self.register_task_data(task, stage_dir)
        self._ensure_initialized(task)
        self.mh = self.mh.add_new_task(task, use_init=not self.TRANSFER_HEADS)
        self.before_task(task)
        self._build_step()
        self._update_manifest(start_training_on=task, checkpoint_should_exist=False)
        self.save_checkpoint("before_training")
        seed_offset = len(self.mh.tasks)
        prefetch = Prefetcher(self._make_sampler(task, True, seed_offset), self.device)
        val_sampler = self._make_sampler(task, False, seed_offset)
        try:
            for epoch in range(num_epochs):
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
        return man

    def save_checkpoint(self, name: str):
        heads = {t: self.mh.assemble(t) for t in self.mh.tasks}
        checkpoints.save_checkpoint(
            os.path.join(self.output_folder, name), heads, self.manifest(),
            optimizer=self.optimizer.state_dict() if self.optimizer else None,
            step=self.global_step, epoch=self.epoch, active_task=self.mh.active_task)
