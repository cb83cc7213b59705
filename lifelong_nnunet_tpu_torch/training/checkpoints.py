"""Checkpoints of the port: ``torch.save`` state plus a JSON manifest.

    <name>.pt     {"heads": {task: state_dict of the assembled U-Net}},
                  and from the trainer also "optimizer" (its state_dict),
                  "step" and "epoch"
    <name>.json   the JAX manifest's keys (``trainer.py:660-684``: plans,
                  trainer, extension, config_name, widths, fold, ...) plus
                  "meta" {"task_order", "active_task"}, "step", "epoch"
                  and "has_opt_state"

Names follow the JAX package and the reference: ``model_final_checkpoint``,
``model_latest``, ``model_best``.  The manifest stores no absolute path.
A served model reads only "heads", so ``restore_model`` takes a trained
checkpoint as it takes a hand-saved one.  Continual-learning state comes
with the CL trainers.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

CKPT_SUFFIX = ".pt"


def vit_manifest(version: str, vit_type: str, lsa: bool, spt: bool,
                 depth_override: int | None) -> dict:
    """The manifest's ``vit`` entry, the JAX trainer's keys
    (``trainer.py:671-679``); task-specific LayerNorms are not ported yet."""
    return {"version": version, "type": vit_type, "lsa": lsa, "spt": spt,
            "task_specific_ln": False, "ln_tasks": [], "active_task_idx": 0,
            "depth_override": depth_override}


def base_manifest(plans, config_name: str, model, trainer: str = "nnUNetTrainerV2",
                  extension: str = "base_v2", fold: int = 0, vit: dict | None = None) -> dict:
    """The JAX manifest's keys for a single-task U-Net, or a ViT-U-Net
    with ``vit`` (:func:`vit_manifest`) trained on the plans' patch."""
    cfg = plans.config(config_name)
    return {
        "plans": dataclasses.asdict(plans),
        "trainer": trainer,
        "extension": extension,
        "config_name": config_name,
        "plans_name": plans.plans_name,
        "task": plans.task,
        "patch_size": list(cfg.patch_size),
        "batch_size": cfg.batch_size,
        "base_num_features": int(model.base_num_features),
        "max_num_features": int(model.max_num_features),
        "use_vit": vit is not None,
        "vit": vit,
        "fold": fold,
        "split_at": None,
        "transfer_heads": False,
        "hyperparams": {},
    }


def save_checkpoint(path_base: str, heads: dict, manifest: dict,
                    optimizer: dict | None = None, step: int = 0, epoch: int = 0,
                    active_task: str | None = None) -> None:
    """``heads``: {task: state_dict}, in task order; ``active_task``
    defaults to the last.  ``optimizer`` is the trainer optimizer's
    ``state_dict``."""
    if not heads:
        raise ValueError("a checkpoint needs at least one head")
    os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
    blob = {"heads": {t: {k: v.detach().cpu() for k, v in sd.items()}
                      for t, sd in heads.items()},
            "step": int(step), "epoch": int(epoch)}
    if optimizer is not None:
        blob["optimizer"] = optimizer
    torch.save(blob, path_base + CKPT_SUFFIX)
    man = dict(manifest)
    man["meta"] = {"task_order": list(heads),
                   "active_task": active_task or list(heads)[-1]}
    man.update({"step": int(step), "epoch": int(epoch),
                "has_opt_state": optimizer is not None})
    with open(path_base + ".json", "w") as f:
        json.dump(man, f, indent=2, default=str)


def load_checkpoint(path_base: str, device: torch.device):
    """Returns ({task: state_dict on ``device``}, manifest)."""
    with open(path_base + ".json") as f:
        manifest = json.load(f)
    blob = torch.load(path_base + CKPT_SUFFIX, map_location=device,
                      weights_only=True)
    order = manifest["meta"]["task_order"]
    return {t: blob["heads"][t] for t in order}, manifest


