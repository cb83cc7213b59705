"""Trainer registry of the port: extension name / class name -> trainer
class.  The other continual-learning trainers of the JAX package
(``lifelong_nnunet_tpu/training/trainers/``: EWC, RW, LwF, MiB, PLOP,
POD, the frozen-* and own-method trainers) come with later parts of the
port; asking for one raises."""

from ..trainer import MultiHeadTrainer
from .rehearsal import RehearsalTrainer
from .sequential import BaseUNetTrainer, SequentialTrainer, ViTUNetTrainer

TRAINER_MAP = {
    "multihead": MultiHeadTrainer,
    "sequential": SequentialTrainer,
    "rehearsal": RehearsalTrainer,
    "base_v2": BaseUNetTrainer,
    "vit_unet": ViTUNetTrainer,
}

# reference class names -> ours
CLASS_NAME_MAP = {
    "nnUNetTrainerV2": BaseUNetTrainer,
    "nnUNetTrainerMultiHead": MultiHeadTrainer,
    "nnUNetTrainerSequential": SequentialTrainer,
    "nnUNetTrainerRehearsal": RehearsalTrainer,
    "nnViTUNetTrainer": ViTUNetTrainer,
}


def get_trainer(name: str):
    if name in TRAINER_MAP:
        return TRAINER_MAP[name]
    if name in CLASS_NAME_MAP:
        return CLASS_NAME_MAP[name]
    raise NotImplementedError(f"trainer/extension {name!r} is not ported yet; the "
                              f"port trains {sorted(TRAINER_MAP)}")
