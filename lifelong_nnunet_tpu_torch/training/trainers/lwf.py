"""The LwF trainer (Learning without Forgetting): the port of
``lifelong_nnunet_tpu/training/trainers/lwf.py``.

The first task trains plain.  Every later task trains in two phases:

1. the freeze run: the body frozen (the trainable mask of ``PolySGD``), the
   new head from ``state_init`` trained for ``freeze_epochs`` (default the
   task's epochs), ending with the ``model_freezed`` checkpoint;
2. joint training: ``cl_state["old_models"]`` snapshots, at the start of
   the phase, the model of every earlier task (body and its head).  Each
   step runs the model, then per earlier task the current body with that
   task's head (with gradient, through ``torch.func.functional_call``) and
   that task's snapshot (under ``torch.no_grad``), and adds
   ``ops/cl_losses.py:lwf_distill_loss`` over the full-resolution outputs
   at ``lwf_temperature`` to the deep-supervision loss.  The earlier heads
   train too: they are parameters of their own (``extra_params``) in the
   phase's fresh optimizer, unmasked, so the clip's global norm and the
   weight decay cover the model and the earlier heads together, as the JAX
   step's optax chain over ``{main, prev_heads}`` does.  They go back into
   the registry at every checkpoint and at the end of the task.  The step
   augments as every other step of the trainer does, with the plans'
   ``dummy_2d``, which the JAX joint step leaves out.

The manifest records the phase (``lwf_phase``: 0 first task, 1 freeze run,
2 joint training), which ``load_checkpoint`` adopts before it rebuilds the
step, so ``-c`` re-enters the phase of ``model_latest`` at its epoch.  A
joint phase resumed from a checkpoint without ``old_models`` rebuilds the
snapshots from the restored heads (the JAX trainer's fallback), which is
exact only if the joint phase had just started.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace

import torch
from torch.func import functional_call

from ...ops.cl_losses import lwf_distill_loss
from ..trainer import MultiHeadTrainer


class LwFTrainer(MultiHeadTrainer):
    EXTENSION = "lwf"
    TRANSFER_HEADS = False
    HYPERPARAMS = {"lwf_temperature": float}

    def __init__(self, *args, lwf_temperature: float = 2.0,
                 freeze_epochs: int | None = None, **kw):
        kw.setdefault("lwf_temperature", lwf_temperature)
        super().__init__(*args, **kw)
        self.lwf_temperature = float(lwf_temperature)
        self.freeze_epochs = freeze_epochs
        self._joint_phase = False
        self._freeze_body = False
        self._loaded_phase = 0
        self._prev_heads: dict = {}     # joint phase: {task: {key: Parameter}}

    def init_cl_state(self):
        return {"old_models": None}

    # ------------------------------------------------ phase-aware checkpoints
    def extra_manifest(self) -> dict:
        return {"lwf_phase": 2 if self._joint_phase else (1 if self._freeze_body else 0)}

    def _adopt_manifest(self, manifest: dict):
        self._loaded_phase = int(manifest.get("lwf_phase", 0))
        self._joint_phase = self._loaded_phase == 2
        self._freeze_body = self._loaded_phase == 1

    def _sync_prev_heads(self):
        """The joint phase's earlier heads into the registry (copies)."""
        if not (self._joint_phase and self._prev_heads):
            return
        heads = OrderedDict(self.mh.heads)
        for t, head in self._prev_heads.items():
            heads[t] = self._global({k: p.detach().clone() for k, p in head.items()})
        self.mh = replace(self.mh, heads=heads)

    def save_checkpoint(self, name: str):
        self._sync_prev_heads()
        super().save_checkpoint(name)

    def after_task(self, task: str):
        self._sync_prev_heads()

    # -------------------------------------------------- the two phases
    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None,
                   start_epoch: int = 0):
        # a first task resumed mid-way is still the first task
        first = self.mh is None or (start_epoch and self._loaded_phase == 0
                                    and self.mh.tasks == [task])
        if first:
            self._joint_phase = False
            super().train_task(task, stage_dir, num_epochs, start_epoch=start_epoch)
            return
        resume_phase = self._loaded_phase if start_epoch else 0
        if resume_phase != 2:
            self._joint_phase, self._freeze_body = False, True
            self._suppress_finalize = True
            fe = self.freeze_epochs if self.freeze_epochs is not None else (
                num_epochs or self.opts.num_epochs)
            self.logger(f"[{task}] LwF phase 1: frozen-body head training ({fe} epochs"
                        + (f", resumed at epoch {start_epoch})" if resume_phase else ")"))
            super().train_task(task, stage_dir, num_epochs=fe,
                               start_epoch=start_epoch if resume_phase == 1 else 0)
            self._suppress_finalize = False
            self.save_checkpoint("model_freezed")
            self.cl_state = {"old_models": {t: self.mh.assemble(t)
                                            for t in self.mh.tasks[:-1]}}
            start_epoch = 0
        elif not isinstance(self.cl_state.get("old_models"), dict):
            self.logger(f"[{task}] LwF resume: rebuilding teacher snapshots from restored heads")
            self.cl_state = {"old_models": {t: self.mh.assemble(t)
                                            for t in self.mh.tasks[:-1]}}
        self._freeze_body, self._joint_phase = False, True
        self._skip_before_ckpt = True
        self.logger(f"[{task}] LwF phase 2: joint training with distillation over "
                    f"{len(self.cl_state['old_models'])} previous heads"
                    + (f", resumed at epoch {start_epoch}" if start_epoch else ""))
        super().train_task(task, stage_dir, num_epochs, start_epoch=start_epoch)
        self._joint_phase = False
        self._skip_before_ckpt = False

    def trainable_mask(self):
        return self.mh.trainable_mask(freeze_body=True) if self._freeze_body else None

    # -------------------------------------------------- the joint step
    def _build_step(self):
        self._prev_heads = {
            t: {k: torch.nn.Parameter(v.detach().clone())
                for k, v in self._local(self.mh.heads[t]).items()}
            for t in self.mh.tasks[:-1]} if self._joint_phase else {}
        super()._build_step()

    def extra_params(self) -> list:
        return [(f"prev_heads.{t}.{k}", p) for t, head in self._prev_heads.items()
                for k, p in head.items()]

    def loss_extras(self):
        if not self._joint_phase:
            return None
        heads, temperature, dp = self._prev_heads, self.lwf_temperature, self.dp

        def extras(model, cl_state, model_out, batch):
            data = batch["data"]
            current, targets = [], []
            for t, head in heads.items():
                current.append(functional_call(model, head, (data,))[0])
                with torch.no_grad():
                    targets.append(functional_call(model, cl_state["old_models"][t],
                                                   (data,))[0])
            dist = lwf_distill_loss(current, targets, temperature, dp=dp)
            return dist, {"lwf_distill": dist.detach()}

        return extras
