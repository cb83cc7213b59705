"""The freezing trainers: the port of
``lifelong_nnunet_tpu/training/trainers/frozen.py`` (``:27-107``).

Each is Sequential or EWC with a trainable mask ``{key: bool}`` that
reaches ``PolySGD`` (``training/optimizer.py``), which leaves the frozen
parameters bit for bit as they are (the reference flips
``requires_grad`` and rebuilds its optimizer):

  * ``frozen_vit``: the ViT frozen from the second task on;
  * ``frozen_nonln``: everything but the ViT's LayerNorms frozen from the
    second task on;
  * ``frozen_unet``: everything but the ViT frozen from the second task on;
  * ``frozen_body_seq`` (reference class ``nnUNetTrainerFrozenBody``): the
    shared body frozen from the second task on, only the head trains;
  * ``froz_ewc``: EWC with the ViT frozen on task indices 1, 3, ...;
    ``adaptive`` scales the EWC lambda by exp(-1/3) on those tasks.

On a plain U-Net the ``vit`` filters match nothing, as in the JAX package:
``frozen_vit`` and ``froz_ewc`` get an all-True mask (no parameter frozen)
and ``frozen_unet`` / ``frozen_nonln`` freeze every parameter after the
first task.
"""

from __future__ import annotations

import math

from ...models.multihead import name_filter_mask
from .ewc import EWCTrainer
from .sequential import SequentialTrainer


def _past_first_task(trainer) -> bool:
    fold = trainer.already_trained_on.get(str(trainer.opts.fold), {})
    return trainer.mh is not None and (
        len(trainer.mh.tasks) > 1 or bool(fold.get("finished_training_on")))


class _FilterFrozenMixin:
    """Freeze the parameters a name filter selects (or the rest) after the
    first task."""
    FREEZE_FILTER: tuple = ((), True)   # (substrings, freeze the matching ones)

    def trainable_mask(self):
        if not _past_first_task(self):
            return None
        subs, freeze_matching = self.FREEZE_FILTER
        frozen = name_filter_mask(self.mh.assemble(), list(subs), include=freeze_matching)
        return {k: not v for k, v in frozen.items()}


class FrozenViTTrainer(_FilterFrozenMixin, SequentialTrainer):
    EXTENSION = "frozen_vit"
    FREEZE_FILTER = (["vit"], True)


class FrozenNonLNTrainer(_FilterFrozenMixin, SequentialTrainer):
    EXTENSION = "frozen_nonln"
    FREEZE_FILTER = (["vit", "norm"], False)


class FrozenUNetTrainer(_FilterFrozenMixin, SequentialTrainer):
    EXTENSION = "frozen_unet"
    FREEZE_FILTER = (["vit"], False)


class FrozenBodyTrainer(SequentialTrainer):
    """The whole body frozen after the first task; the head trains."""
    EXTENSION = "frozen_body_seq"

    def trainable_mask(self):
        if not _past_first_task(self):
            return None
        return self.mh.trainable_mask(freeze_body=True)


class FrozEWCTrainer(EWCTrainer):
    """EWC with the ViT frozen on every second task (task indices 1, 3,
    ...); ``adaptive`` shrinks lambda by exp(-1/3) while frozen."""
    EXTENSION = "froz_ewc"
    HYPERPARAMS = {"ewc_lambda": float, "adaptive": bool}

    def __init__(self, *args, adaptive: bool = False, **kw):
        kw.setdefault("adaptive", adaptive)
        super().__init__(*args, **kw)
        self.adaptive = bool(adaptive)
        self._base_lambda = self.ewc_lambda

    def _vit_frozen_now(self) -> bool:
        return self.mh is not None and (len(self.mh.tasks) - 1) % 2 == 1

    def before_task(self, task: str):
        super().before_task(task)
        frozen = self._vit_frozen_now()
        self.ewc_lambda = self._base_lambda * math.exp(-1.0 / 3.0) \
            if self.adaptive and frozen else self._base_lambda
        if frozen:
            self.logger(f"[{task}] froz_ewc: ViT frozen this task"
                        + (f", lambda -> {self.ewc_lambda:.4f}" if self.adaptive else ""))

    def trainable_mask(self):
        if not self._vit_frozen_now():
            return None
        vit = name_filter_mask(self.mh.assemble(), ["vit"], include=True)
        return {k: not v for k, v in vit.items()}
