"""Sequential trainer and the plain single-task trainer: the port of
``lifelong_nnunet_tpu/training/trainers/sequential.py``.

``SequentialTrainer`` transfers the previous task's trained head to a new
task (``TRANSFER_HEADS``), with no CL regularization; ``BaseUNetTrainer``
is the plain single-task trainer, the stand-in for upstream
``nnUNetTrainerV2`` base models; ``ViTUNetTrainer`` is the single-task
trainer of ``nnUNet_torch_train_vit`` (the JAX package's, defined in its
``run/run_training_vit.py``; reference ``nnViTUNetTrainer``).
"""

from ..trainer import MultiHeadTrainer


class SequentialTrainer(MultiHeadTrainer):
    EXTENSION = "sequential"
    TRANSFER_HEADS = True


class BaseUNetTrainer(SequentialTrainer):
    EXTENSION = "base_v2"


class ViTUNetTrainer(SequentialTrainer):
    EXTENSION = "vit_unet"
