"""The PLOP and POD trainers (Pooled Output Distillation, with or without
pseudo-labels): the port of ``lifelong_nnunet_tpu/training/trainers/plop.py``.

From the second task on, a frozen copy of the model after the previous task
(snapshot in ``before_task`` into ``cl_state["teacher"]``) runs on every
batch beside the model, through ``torch.func.functional_call`` under
``torch.no_grad`` with ``capture_taps`` (so on the same kernels), and the
loss adds ``local_pod_loss`` between the student's and the teacher's taps
(``ops/cl_losses.py``).  PLOP replaces the DC+CE base by the pseudo-label
loss per deep-supervision output, against per-class thresholds that
``before_task`` computes once per task: ``iters_per_epoch`` unaugmented
training batches (sampler seed offset 555) through the teacher, a 100-bin
histogram of its entropy confidence over the background voxels per output,
its median per class (``cl_state["thresholds"]``, a list of ``[C]``
tensors).  POD keeps DC+CE and has no thresholds.  The first task trains
plain.  Heads transfer, as in the Sequential trainer.

Over several ranks each rank histograms its rows of the threshold pass's
global batches and the histograms are summed over the data ranks before
the medians, so every rank takes the global batches' thresholds.

A task resumed mid-way (``-c`` from ``model_latest``) keeps the teacher and
the thresholds its checkpoint holds; the JAX trainer snapshots the teacher
again from the registry, whose body has moved since, and computes the
thresholds from that.  The kept thresholds are not computed again: the pass
is a function of the teacher and the seeded sampler, so it would give them
bit for bit.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ...ops.cl_losses import (accumulate_entropy_histogram, local_pod_loss,
                              median_entropy_thresholds, plop_pseudo_label_loss)
from ...ops.losses import deep_supervision_loss, downsample_target, ds_weights
from ..trainer import MultiHeadTrainer

HIST_BINS = 100
THRESHOLD_SEED_OFFSET = 555   # the JAX trainer's threshold sampler


class PLOPTrainer(MultiHeadTrainer):
    EXTENSION = "plop"
    TRANSFER_HEADS = True
    HYPERPARAMS = {"pod_lambda": float, "pod_scales": int}
    PSEUDO = True   # POD turns this off

    def __init__(self, *args, pod_lambda: float = 1e-2, pod_scales: int = 3, **kw):
        kw.setdefault("pod_lambda", pod_lambda)
        kw.setdefault("pod_scales", pod_scales)
        super().__init__(*args, **kw)
        self.pod_lambda = float(pod_lambda)
        self.pod_scales = int(pod_scales)
        self._resuming = False

    def init_cl_state(self):
        return {"teacher": None, "thresholds": None}

    def train_task(self, task: str, stage_dir: str, num_epochs: int | None = None,
                   start_epoch: int = 0):
        self._resuming = bool(start_epoch)
        super().train_task(task, stage_dir, num_epochs, start_epoch=start_epoch)

    def before_task(self, task: str):
        if self.mh is None or len(self.mh.tasks) < 2:
            return
        if self._resuming and self.cl_state.get("teacher") is not None:
            self.logger(f"[{task}] {self.EXTENSION}: teacher and thresholds kept from the "
                        "checkpoint")
            return
        prev = self.mh.tasks[-2]
        teacher = self.mh.assemble(prev)
        thresholds = self.compute_thresholds(task, teacher) if self.PSEUDO else None
        self.cl_state = {"teacher": teacher, "thresholds": thresholds}
        self.logger(f"[{task}] {self.EXTENSION}: teacher = model after {prev}"
                    + ("" if thresholds is None else ", thresholds computed"))

    def compute_thresholds(self, task: str, teacher: dict) -> list:
        """The per-class median-entropy thresholds of each deep-supervision
        output over one epoch of the teacher's predictions, in f32."""
        nc = self.num_classes
        hists = [torch.zeros(nc, HIST_BINS, device=self.device) for _ in self.ds_factors]
        sampler = self._make_sampler(task, True, seed_offset=THRESHOLD_SEED_OFFSET)
        teacher = self._local(teacher)
        with torch.no_grad():
            for _ in range(self.opts.iters_per_epoch):
                b = sampler.next_batch()
                data = torch.from_numpy(b["data"]).to(self.device)
                seg = torch.from_numpy(b["seg"]).to(self.device).long()
                outs = functional_call(self.model, teacher, (data,))
                hists = [accumulate_entropy_histogram(h, o, downsample_target(seg, f), nc,
                                                      HIST_BINS)
                         for h, o, f in zip(hists, outs, self.ds_factors)]
        if self.dp is not None:
            # the histogram of the global batches
            self.dp.sum_flat_(hists)
        return [median_entropy_thresholds(h) for h in hists]

    def loss_extras(self):
        if self.cl_state.get("teacher") is None:
            return None
        dsf, batch_dice = self.ds_factors, self.batch_dice
        pod_lambda, scales, pseudo = self.pod_lambda, self.pod_scales, self.PSEUDO
        dp = self.dp

        def extras(model, cl_state, model_out, batch):
            outputs, taps, seg = model_out["outputs"], model_out["taps"], batch["seg"]
            with torch.no_grad():
                t_out, t_taps = functional_call(model, cl_state["teacher"], (batch["data"],),
                                                {"capture_taps": True})
            pod = local_pod_loss(taps, t_taps, scales, pod_lambda, dp=dp)
            if not pseudo:
                base = deep_supervision_loss(outputs, seg, dsf, batch_dice, dp=dp)
                return base + pod, {"pod": pod.detach()}
            w = ds_weights(len(outputs))
            ps = 0.0
            for i, (o, to, f) in enumerate(zip(outputs, t_out, dsf)):
                if w[i] == 0.0:
                    continue
                ps = ps + float(w[i]) * plop_pseudo_label_loss(
                    o, to, downsample_target(seg, f), cl_state["thresholds"][i], dp=dp)
            return ps + pod, {"plop_pseudo": ps.detach(), "pod": pod.detach()}

        extras.replace_base = True
        extras.needs_taps = True
        return extras


class PODTrainer(PLOPTrainer):
    """POD alone: DC+CE plus ``pod_lambda`` x local POD, no pseudo-labels and
    no thresholds."""
    EXTENSION = "pod"
    PSEUDO = False
