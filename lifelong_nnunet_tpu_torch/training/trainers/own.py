"""The own-method trainers OwnM1-OwnM4 (the reference authors' hybrids): the
port of ``lifelong_nnunet_tpu/training/trainers/own.py``, on the port's
EWC trainer (``trainers/ewc.py``: the fisher pass after each task, the
anchors in ``cl_state["ewc_tasks"]``, the penalty's gradient written into
``.grad`` after the backward).

From the second task on, a frozen copy of the model after the previous task
(``cl_state["teacher"]``, snapshot in ``before_task``) runs on every batch
beside the model through ``torch.func.functional_call`` under
``torch.no_grad`` with ``capture_taps``; POD distils the decoder taps
(``dec*``) only, the JAX trainers' stand-in for the reference's hooks on the
head convs.

  * OwnM1: DC+CE + EWC on the ViT's parameters + ``mib_lkd`` x MiB's
    unbiased KD at ``mib_alpha`` per deep-supervision output + POD.  The
    reference's Own1 loss also adds ``lkd_loss(x[0], y[0])``, an unbiased
    KD against the integer ground truth, which does not type-check against
    the KD's definition; the JAX trainer leaves it out, and so does this.
  * OwnM2: OwnM1 with EWC on every parameter.
  * OwnM3: OwnM2 with ``USE_SPT = True``.  Nothing reads that attribute, in
    the JAX package either: SPT comes from ``--do_SPT`` alone, so OwnM3
    trains as OwnM2 does.
  * OwnM4: DC+CE + EWC + a ramped MSE between the student's and the
    teacher's logits + POD.  A step counter ``cl_state["iter"]`` (with
    ``"epoch"`` = iter // iters_per_epoch) set up with the trainer and
    running on across tasks, as in the JAX trainer; on every 13th step
    (iter % 13 == 0) the MSE weighs ``pseudo_alpha`` x the epoch's ramp
    (0 before E/10, linear to 1 at E - E/10, E = ``num_epochs``), on the
    others 0; a step whose weight is > 0 drops the EWC penalty.

A task resumed mid-way (``-c`` from ``model_latest``) keeps the teacher (and
OwnM4's counter) its checkpoint holds, as MiB does; the JAX trainers
snapshot the teacher again from the registry, whose body has moved since.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ...ops.cl_losses import local_pod_loss, unbiased_kd_loss
from ...ops.losses import deep_supervision_loss, ds_weights, gmean
from .ewc import EWCTrainer

PSEUDO_EVERY = 13   # OwnM4's pseudo iterations (the reference's ownm4/...:322-343)


def _decoder_taps(taps: dict) -> dict:
    return {k: v for k, v in taps.items() if k.startswith("dec")}


class _OwnLoss:
    """The train step's ``loss_extras`` of an OwnM trainer with a teacher:
    the whole objective (``replace_base``) from the student's taps
    (``needs_taps``), with the EWC penalty ``penalty`` (a
    :class:`~...ops.cl_losses.QuadraticPenalty` or None) added where
    ``terms`` says, its gradient by :meth:`add_grad`."""

    replace_base = True
    needs_taps = True

    def __init__(self, trainer, penalty, terms):
        self.penalty, self.terms = penalty, terms
        self.dsf, self.batch_dice, self.dp = trainer.ds_factors, trainer.batch_dice, trainer.dp
        self.pod_lambda, self.scales = trainer.pod_lambda, trainer.pod_scales

    def __call__(self, model, cl_state, model_out, batch):
        outputs, taps, seg = model_out["outputs"], model_out["taps"], batch["seg"]
        with torch.no_grad():
            t_out, t_taps = functional_call(model, cl_state["teacher"], (batch["data"],),
                                            {"capture_taps": True})
        base = deep_supervision_loss(outputs, seg, self.dsf, self.batch_dice, dp=self.dp)
        loss, aux = self.terms(cl_state, base, outputs, t_out, ds_weights(len(outputs)),
                               self._penalty)
        pod = local_pod_loss(_decoder_taps(taps), _decoder_taps(t_taps), self.scales,
                             self.pod_lambda, dp=self.dp)
        aux["pod"] = pod.detach()
        return loss + pod, aux

    def _penalty(self):
        """The EWC penalty's value (0 without anchors); its gradient is kept
        for :meth:`add_grad`."""
        if self.penalty is None:
            return 0.0
        value, _ = self.penalty()
        return value

    def add_grad(self):
        if self.penalty is not None:
            self.penalty.add_grad()


class _OwnTrainer(EWCTrainer):
    """What the OwnM trainers share: heads transfer, the teacher snapshot
    (kept from the checkpoint on a mid-task resume) and the loss hook; a
    subclass gives its terms (``_terms``)."""
    TRANSFER_HEADS = True
    _resuming = False

    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None,
                   start_epoch: int = 0):
        self._resuming = bool(start_epoch)
        super().train_task(task, stage_dir, num_epochs, start_epoch=start_epoch)

    def before_task(self, task: str):
        if self.mh is None or len(self.mh.tasks) < 2:
            return
        if self._resuming and self.cl_state.get("teacher") is not None:
            self.logger(f"[{task}] {self.EXTENSION}: teacher kept from the checkpoint")
            return
        prev = self.mh.tasks[-2]
        self.cl_state["teacher"] = self.mh.assemble(prev)
        self.logger(f"[{task}] {self.EXTENSION}: teacher = model after {prev}")

    def loss_extras(self):
        penalty = super().loss_extras()
        if self.cl_state.get("teacher") is None:
            return penalty
        return _OwnLoss(self, penalty, self._terms)


class OwnM1Trainer(_OwnTrainer):
    EXTENSION = "ownm1"
    HYPERPARAMS = {"mib_alpha": float, "mib_lkd": float, "pod_lambda": float,
                   "pod_scales": int, "ewc_lambda": float}
    PARAM_FILTER = (["vit"], True)     # EWC on the ViT only

    def __init__(self, *args, mib_alpha: float = 1.0, mib_lkd: float = 10.0,
                 pod_lambda: float = 1e-2, pod_scales: int = 3, **kw):
        kw.setdefault("mib_alpha", mib_alpha)
        kw.setdefault("mib_lkd", mib_lkd)
        kw.setdefault("pod_lambda", pod_lambda)
        kw.setdefault("pod_scales", pod_scales)
        super().__init__(*args, **kw)
        self.mib_alpha = float(mib_alpha)
        self.mib_lkd = float(mib_lkd)
        self.pod_lambda = float(pod_lambda)
        self.pod_scales = int(pod_scales)

    def init_cl_state(self):
        return {"ewc_tasks": {}, "teacher": None}

    def _terms(self, cl_state, base, outputs, t_out, w, penalty):
        """DC+CE + EWC + the weighted unbiased KD per output."""
        pen = penalty()
        loss = base + pen
        aux = {"ewc_penalty": pen} if torch.is_tensor(pen) else {}
        kd = 0.0
        for i, (o, to) in enumerate(zip(outputs, t_out)):
            if w[i] == 0.0:
                continue
            kd = kd + float(w[i]) * self.mib_lkd * unbiased_kd_loss(
                o, to, self.num_classes, self.mib_alpha, dp=self.dp)
        aux["mib_kd"] = kd.detach()
        return loss + kd, aux


class OwnM2Trainer(OwnM1Trainer):
    """EWC on every parameter."""
    EXTENSION = "ownm2"
    PARAM_FILTER = None


class OwnM3Trainer(OwnM2Trainer):
    """OwnM2 with ``USE_SPT``, which nothing reads (module docstring)."""
    EXTENSION = "ownm3"
    USE_SPT = True


class OwnM4Trainer(_OwnTrainer):
    """EWC + the ramped pseudo-label MSE against the previous model + POD
    (module docstring)."""
    EXTENSION = "ownm4"
    HYPERPARAMS = {"pseudo_alpha": float, "pod_lambda": float, "pod_scales": int,
                   "ewc_lambda": float}
    PARAM_FILTER = None

    def __init__(self, *args, pseudo_alpha: float = 3.0, pod_lambda: float = 1e-2,
                 pod_scales: int = 3, **kw):
        kw.setdefault("pseudo_alpha", pseudo_alpha)
        kw.setdefault("pod_lambda", pod_lambda)
        kw.setdefault("pod_scales", pod_scales)
        super().__init__(*args, **kw)
        self.pseudo_alpha = float(pseudo_alpha)
        self.pod_lambda = float(pod_lambda)
        self.pod_scales = int(pod_scales)

    def init_cl_state(self):
        return {"ewc_tasks": {}, "teacher": None, "iter": 0, "epoch": 0}

    def cl_state_update(self):
        ipe = self.opts.iters_per_epoch

        def update(cl_state, model, loss):
            it = cl_state["iter"] + 1
            return {**cl_state, "iter": it, "epoch": it // ipe}

        return update

    def pseudo_weight(self, it: int, epoch: int) -> float:
        """The MSE's weight at step ``it`` of epoch ``epoch``, in f32 as the
        JAX trainer computes it."""
        if it % PSEUDO_EVERY:
            return 0.0
        f32 = np.float32
        E = self.opts.num_epochs
        t1, t2 = E / 10.0, E - E / 10.0
        ramp = np.clip((f32(epoch) - f32(t1)) / f32(max(t2 - t1, 1e-6)), f32(0), f32(1))
        return float(ramp * f32(self.pseudo_alpha))

    def _terms(self, cl_state, base, outputs, t_out, w, penalty):
        """DC+CE + weight x MSE + EWC where the weight is 0."""
        weight = self.pseudo_weight(cl_state["iter"], cl_state["epoch"])
        mse = 0.0
        for i, (o, to) in enumerate(zip(outputs, t_out)):
            if w[i] == 0.0:
                continue
            mse = mse + float(w[i]) * gmean((o - to) ** 2, self.dp)
        loss = base + weight * mse
        if weight <= 0:
            loss = loss + penalty()
        return loss, {"pseudo_mse": mse.detach()}
