"""Trainer registry of the port: extension name / class name -> trainer
class, as the JAX package's
(``lifelong_nnunet_tpu/training/trainers/__init__.py:20-76``), the cascade
trainer (``inference/cascade.py``) resolved late by :func:`get_trainer`,
as there (that module imports this registry)."""

from ..trainer import MultiHeadTrainer
from .ewc import EWCLNTrainer, EWCTrainer, EWCUNetTrainer, EWCViTTrainer
from .frozen import (FrozEWCTrainer, FrozenBodyTrainer, FrozenNonLNTrainer,
                     FrozenUNetTrainer, FrozenViTTrainer)
from .lwf import LwFTrainer
from .mib import MiBTrainer
from .own import OwnM1Trainer, OwnM2Trainer, OwnM3Trainer, OwnM4Trainer
from .plop import PLOPTrainer, PODTrainer
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
    "lwf": LwFTrainer,
    "mib": MiBTrainer,
    "plop": PLOPTrainer,
    "pod": PODTrainer,
    "ownm1": OwnM1Trainer,
    "ownm2": OwnM2Trainer,
    "ownm3": OwnM3Trainer,
    "ownm4": OwnM4Trainer,
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
    "nnUNetTrainerLWF": LwFTrainer,
    "nnUNetTrainerMiB": MiBTrainer,
    "nnUNetTrainerPLOP": PLOPTrainer,
    "nnUNetTrainerPOD": PODTrainer,
    "nnUNetTrainerOwnM1": OwnM1Trainer,
    "nnUNetTrainerOwnM2": OwnM2Trainer,
    "nnUNetTrainerOwnM3": OwnM3Trainer,
    "nnUNetTrainerOwnM4": OwnM4Trainer,
}


def get_trainer(name: str):
    if name in ("cascade_fullres", "CascadeFullResTrainer",
                "nnViTUNetTrainer_CascadeFullRes"):
        from ...inference.cascade import CascadeFullResTrainer
        return CascadeFullResTrainer
    if name in TRAINER_MAP:
        return TRAINER_MAP[name]
    if name in CLASS_NAME_MAP:
        return CLASS_NAME_MAP[name]
    raise KeyError(f"unknown trainer/extension {name!r}; known: {sorted(TRAINER_MAP)}")
