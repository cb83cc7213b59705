"""Sequential trainer and the plain single-task trainer: the port of
``lifelong_nnunet_tpu/training/trainers/sequential.py``.

``SequentialTrainer`` transfers the previous task's trained head to a new
task (``TRANSFER_HEADS``), with no CL regularization; ``BaseUNetTrainer``
is the plain single-task trainer, the stand-in for upstream
``nnUNetTrainerV2`` base models.
"""

from ..trainer import MultiHeadTrainer


class SequentialTrainer(MultiHeadTrainer):
    EXTENSION = "sequential"
    TRANSFER_HEADS = True


class BaseUNetTrainer(SequentialTrainer):
    EXTENSION = "base_v2"
