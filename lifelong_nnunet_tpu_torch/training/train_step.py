"""The training step: the port of ``lifelong_nnunet_tpu/training/train_step.py``.

    (cl_state, batch) -> (cl_state, metrics)

One call augments the batch on its device, runs the forward, the
deep-supervision loss, the backward, the clip and the optimizer step, and
returns the loss and the hard tp/fp/fn of the full-resolution output as
device tensors (nothing waits for the device).  Its spans (``tracing.py``):
``train.step`` over the call, carrying the step's ordinal, and the device
times of its phases ``step.augment``, ``step.forward`` (with the loss),
``step.backward`` (with the gradient all-reduce) and ``step.optimizer``
(with ``cl_state_update`` and the clip).

Under data parallelism (``cfg.dp``) the step is GSPMD's on the global
batch: augmentation draws for the whole batch and keeps the rank's rows,
the losses reduce over the data group (``ops/losses.py``), one coalesced
all-reduce sums the gradients of every trainable tensor (LwF's heads
included) right after the backward, and only then are the parameter-only
terms (``add_grad``) added, ``cl_state_update`` reads the gradients and
the optimizer clips (over the model group too, under model parallelism)
and steps.  Every rank so applies the same update, the gradient of the
global-batch loss.  Differences between
continual-learning methods live in the ``loss_extras`` and
``cl_state_update`` hooks, kept as arguments; the single-task trainers pass
neither.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import torch

from .. import tracing
from ..data.augment import AugmentConfig, augment_batch
from ..ops.losses import deep_supervision_loss, online_eval_counts


@dataclass(frozen=True)
class StepConfig:
    ds_factors: tuple          # deep-supervision downsample factors
    batch_dice: bool
    num_classes: int           # incl. background
    augment: AugmentConfig | None = None
    # data parallelism: the rank's DataGroup and its rows (lo, hi, global
    # batch) of the global batch; None on one rank
    dp: object = None
    rows: tuple | None = None


def make_train_step(model, optimizer, cfg: StepConfig,
                    loss_extras: Callable | None = None,
                    cl_state_update: Callable | None = None,
                    generator: torch.Generator | None = None):
    """``optimizer``: a :class:`~..training.optimizer.PolySGD` over the
    model's parameters; ``generator``: the augmentation's, on the batch's
    device.

    loss_extras(model, cl_state, {"outputs", "taps"}, {"data", "seg"}) -> (extra, aux)
        adds a CL term; with ``loss_extras.replace_base`` it is the whole
        objective.  With ``loss_extras.needs_taps`` the forward captures the
        model's taps (``models/unet.py``), else ``"taps"`` is None.  A term with an ``add_grad()`` method (the quadratic
        penalties of ``ops/cl_losses.py``) returns its value without an
        autograd graph and adds its own gradient to ``.grad`` after the
        backward of the rest.
    cl_state_update(cl_state, model, loss) -> cl_state
        per-iteration CL state upkeep; sees the parameters before the
        update, the gradients of the total loss before the clip in
        ``.grad``, and the total loss (the JAX step's ``(cl_state, params,
        grads, loss)``).
    """
    replace_base = getattr(loss_extras, "replace_base", False)
    needs_taps = getattr(loss_extras, "needs_taps", False)
    add_grad = getattr(loss_extras, "add_grad", None)
    if cfg.augment is not None and generator is None:
        raise ValueError("augmentation needs a torch.Generator on the batch's device")

    ordinal = itertools.count()

    def train_step(cl_state, batch: dict):
        with tracing.span("train.step", step=next(ordinal)):
            data, seg = batch["data"], batch["seg"]
            with tracing.span("step.augment", device=True):
                if cfg.augment is not None:
                    data, seg = augment_batch(data, seg, cfg.augment, generator, rows=cfg.rows)
                seg = seg.long()
            optimizer.zero_grad()
            with tracing.span("step.forward", device=True):
                outputs, taps = model(data, capture_taps=True) if needs_taps \
                    else (model(data), None)
                model_out = {"outputs": outputs, "taps": taps}
                aux = {}
                if replace_base:
                    loss, aux = loss_extras(model, cl_state, model_out,
                                            {"data": data, "seg": seg})
                else:
                    loss = deep_supervision_loss(outputs, seg, cfg.ds_factors, cfg.batch_dice,
                                                 dp=cfg.dp)
                    if loss_extras is not None:
                        extra, aux = loss_extras(model, cl_state, model_out,
                                                 {"data": data, "seg": seg})
                        loss = loss + extra
            with tracing.span("step.backward", device=True):
                loss.backward()
                if cfg.dp is not None:
                    cfg.dp.all_reduce_grads(optimizer.all_params)
                if add_grad is not None:
                    add_grad()
            with tracing.span("step.optimizer", device=True):
                if cl_state_update is not None:
                    cl_state = cl_state_update(cl_state, model, loss.detach())
                optimizer.step()
            tp, fp, fn = online_eval_counts(outputs[0].detach(), seg, cfg.num_classes,
                                            dp=cfg.dp)
            return cl_state, {"loss": loss.detach(), "tp": tp, "fp": fp, "fn": fn, **aux}

    return train_step


def make_eval_step(model, cfg: StepConfig):
    """Validation-loss step: no gradient, no augmentation."""

    @torch.no_grad()
    def eval_step(batch: dict):
        outputs = model(batch["data"])
        seg = batch["seg"].long()
        loss = deep_supervision_loss(outputs, seg, cfg.ds_factors, cfg.batch_dice, dp=cfg.dp)
        tp, fp, fn = online_eval_counts(outputs[0], seg, cfg.num_classes, dp=cfg.dp)
        return {"loss": loss, "tp": tp, "fp": fp, "fn": fn}

    return eval_step
