"""Trainer registry of the port: extension name / class name -> trainer
class, as the JAX package's
(``lifelong_nnunet_tpu/training/trainers/__init__.py:20-66``).  The
distilling trainers of the JAX package (LwF, MiB, PLOP, POD) and the
own-method trainers (``ownm1-4``) come with later parts of the port;
asking for one raises."""

from ..trainer import MultiHeadTrainer
from .ewc import EWCLNTrainer, EWCTrainer, EWCUNetTrainer, EWCViTTrainer
from .frozen import (FrozEWCTrainer, FrozenBodyTrainer, FrozenNonLNTrainer,
                     FrozenUNetTrainer, FrozenViTTrainer)
from .rehearsal import RehearsalTrainer
from .rw import RWTrainer
from .sequential import BaseUNetTrainer, SequentialTrainer, ViTUNetTrainer

TRAINER_MAP = {
    "multihead": MultiHeadTrainer,
    "sequential": SequentialTrainer,
    "rehearsal": RehearsalTrainer,
    "base_v2": BaseUNetTrainer,
    "vit_unet": ViTUNetTrainer,
    "ewc": EWCTrainer,
    "ewc_vit": EWCViTTrainer,
    "ewc_unet": EWCUNetTrainer,
    "ewc_ln": EWCLNTrainer,
    "rw": RWTrainer,
    "frozen_vit": FrozenViTTrainer,
    "frozen_nonln": FrozenNonLNTrainer,
    "frozen_unet": FrozenUNetTrainer,
    "frozen_body_seq": FrozenBodyTrainer,
    "froz_ewc": FrozEWCTrainer,
}

# reference class names -> ours
CLASS_NAME_MAP = {
    "nnUNetTrainerV2": BaseUNetTrainer,
    "nnUNetTrainerMultiHead": MultiHeadTrainer,
    "nnUNetTrainerSequential": SequentialTrainer,
    "nnUNetTrainerRehearsal": RehearsalTrainer,
    "nnViTUNetTrainer": ViTUNetTrainer,
    "nnUNetTrainerEWC": EWCTrainer,
    "nnUNetTrainerEWCViT": EWCViTTrainer,
    "nnUNetTrainerEWCUNet": EWCUNetTrainer,
    "nnUNetTrainerEWCLN": EWCLNTrainer,
    "nnUNetTrainerRW": RWTrainer,
    "nnUNetTrainerFrozenViT": FrozenViTTrainer,
    "nnUNetTrainerFrozenNonLN": FrozenNonLNTrainer,
    "nnUNetTrainerFrozenUNet": FrozenUNetTrainer,
    "nnUNetTrainerFrozenBody": FrozenBodyTrainer,
    "nnUNetTrainerFrozEWC": FrozEWCTrainer,
}


def get_trainer(name: str):
    if name in TRAINER_MAP:
        return TRAINER_MAP[name]
    if name in CLASS_NAME_MAP:
        return CLASS_NAME_MAP[name]
    raise NotImplementedError(f"trainer/extension {name!r} is not ported yet; the "
                              f"port trains {sorted(TRAINER_MAP)}")
