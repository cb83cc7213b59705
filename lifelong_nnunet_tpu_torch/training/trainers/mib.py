"""The MiB trainer (Modeling the Background): the port of
``lifelong_nnunet_tpu/training/trainers/mib.py``.

From the second task on, a frozen copy of the model after the previous
task (body and the previous task's head, snapshot in ``before_task`` into
``cl_state["teacher"]``) runs on every batch beside the model, through
``torch.func.functional_call`` under ``torch.no_grad`` (so on the same
kernels), and the loss is, per deep-supervision output, the plain CE plus
``mib_lkd`` times the unbiased knowledge distillation at ``mib_alpha``
(``ops/cl_losses.py:mib_loss``, with ``old_num_classes`` the number of
classes, as the JAX trainer passes it).  The first task trains plain.
Heads transfer, as in the Sequential trainer.

A task resumed mid-way (``-c`` from ``model_latest``) keeps the teacher its
checkpoint holds; the JAX trainer snapshots it again from the registry, whose
body has moved since.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ...ops.cl_losses import mib_loss
from ...ops.losses import ds_weights
from ..trainer import MultiHeadTrainer


class MiBTrainer(MultiHeadTrainer):
    EXTENSION = "mib"
    TRANSFER_HEADS = True
    HYPERPARAMS = {"mib_alpha": float, "mib_lkd": float}

    def __init__(self, *args, mib_alpha: float = 0.9, mib_lkd: float = 10.0, **kw):
        kw.setdefault("mib_alpha", mib_alpha)
        kw.setdefault("mib_lkd", mib_lkd)
        super().__init__(*args, **kw)
        self.mib_alpha = float(mib_alpha)
        self.mib_lkd = float(mib_lkd)
        self._resuming = False

    def init_cl_state(self):
        return {"teacher": None}

    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None,
                   start_epoch: int = 0):
        self._resuming = bool(start_epoch)
        super().train_task(task, stage_dir, num_epochs, start_epoch=start_epoch)

    def before_task(self, task: str):
        if self.mh is None or len(self.mh.tasks) < 2:
            return
        if self._resuming and self.cl_state.get("teacher") is not None:
            self.logger(f"[{task}] MiB teacher kept from the checkpoint")
            return
        prev = self.mh.tasks[-2]
        self.cl_state = {"teacher": self.mh.assemble(prev)}
        self.logger(f"[{task}] MiB teacher = model after {prev}")

    def loss_extras(self):
        if self.cl_state.get("teacher") is None:
            return None
        alpha, lkd, nc, dsf = self.mib_alpha, self.mib_lkd, self.num_classes, self.ds_factors
        dp = self.dp

        def extras(model, cl_state, model_out, batch):
            outputs = model_out["outputs"]
            with torch.no_grad():
                t_out = functional_call(model, cl_state["teacher"], (batch["data"],))
            loss = mib_loss(outputs, t_out, batch["seg"], ds_weights(len(outputs)), dsf,
                            old_num_classes=nc, lkd=lkd, alpha=alpha, dp=dp)
            return loss, {"mib": loss.detach()}

        extras.replace_base = True
        return extras
