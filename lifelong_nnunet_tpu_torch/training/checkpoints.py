"""Checkpoints of the port: ``torch.save`` state plus a JSON manifest.

A trainer's checkpoint keeps the multi-head registry, as the JAX package's
(``lifelong_nnunet_tpu/training/checkpoints.py``) does:

    <name>.pt     {"body": state_dict part, "heads": {task: head part},
                   "state_init": the initial head ({} for trainers whose
                   new heads copy the active head, JAX's
                   ``include_state_init``), "optimizer" (its state_dict),
                   "cl_state" (the method's continual-learning state: a
                   nested dict of tensors, lists, ints and None, such as
                   EWC's fisher and anchors), "step", "epoch"}
    <name>.json   the JAX manifest's keys (``trainer.py:660-684``: plans,
                  trainer, extension, config_name, widths, fold, ...) plus
                  "meta" {"split_at", "module_order", "active_task",
                  "task_order"}, "step", "epoch", "has_opt_state" and
                  "has_cl_state"

A model saved by hand (:func:`save_checkpoint`) keeps one full
``state_dict`` per task instead: ``{"heads": {task: state_dict}}`` with
"meta" {"task_order", "active_task"}.  :func:`load_checkpoint` gives one
full ``state_dict`` per task from either, which is all that serving reads;
:func:`load_registry` gives the registry of either.  A checkpoint written
before ``cl_state`` was kept (no "cl_state", no "has_cl_state") still
loads, with no CL state.

Names follow the JAX package and the reference: ``model_final_checkpoint``,
``model_latest``, ``model_best``.  The manifest stores no absolute path.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import torch

from ..models.multihead import MultiHeadParams, split_params

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


def _cpu(tree):
    """A copy of a nested dict / list of tensors with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def _write(path_base: str, blob: dict, manifest: dict, meta: dict, step: int,
           epoch: int) -> None:
    os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
    torch.save(dict(blob, step=int(step), epoch=int(epoch)), path_base + CKPT_SUFFIX)
    man = dict(manifest)
    man.update({"meta": meta, "step": int(step), "epoch": int(epoch),
                "has_opt_state": "optimizer" in blob,
                "has_cl_state": blob.get("cl_state") is not None})
    with open(path_base + ".json", "w") as f:
        json.dump(man, f, indent=2, default=str)


def save_checkpoint(path_base: str, heads: dict, manifest: dict) -> None:
    """A model saved by hand: ``heads`` {task: full state_dict}, in task
    order, the last one active."""
    if not heads:
        raise ValueError("a checkpoint needs at least one head")
    _write(path_base, {"heads": {t: _cpu(sd) for t, sd in heads.items()}}, manifest,
           {"task_order": list(heads), "active_task": list(heads)[-1]}, 0, 0)


def save_registry(path_base: str, mh: MultiHeadParams, manifest: dict,
                  optimizer: dict | None = None, step: int = 0, epoch: int = 0,
                  include_state_init: bool = True, cl_state=None) -> None:
    """A trainer's checkpoint: the registry ``mh`` (``state_init`` left out
    unless ``include_state_init``), the optimizer's state_dict and the
    trainer's ``cl_state``."""
    blob = {"body": _cpu(mh.body), "heads": {t: _cpu(h) for t, h in mh.heads.items()},
            "state_init": _cpu(mh.state_init) if include_state_init else {}}
    if optimizer is not None:
        blob["optimizer"] = optimizer
    if cl_state is not None:
        blob["cl_state"] = _cpu(cl_state)
    _write(path_base, blob, manifest,
           {"split_at": mh.split_at, "module_order": list(mh.module_order),
            "active_task": mh.active_task, "task_order": mh.tasks}, step, epoch)


def _read(path_base: str, device: torch.device):
    with open(path_base + ".json") as f:
        manifest = json.load(f)
    blob = torch.load(path_base + CKPT_SUFFIX, map_location=device, weights_only=True)
    return blob, manifest


def load_registry(path_base: str, device: torch.device, module_order: list):
    """Returns (MultiHeadParams on ``device``, blob, manifest); the blob's
    "cl_state", where the checkpoint has one, is on ``device`` too.  A model
    saved by hand is split at the manifest's ``split_at`` (default the seg
    heads) in ``module_order``, with no ``state_init``."""
    blob, manifest = _read(path_base, device)
    meta = manifest["meta"]
    order = meta["task_order"]
    if "body" in blob:
        heads = OrderedDict((t, blob["heads"][t]) for t in order)
        mh = MultiHeadParams(body=blob["body"], heads=heads,
                             split_at=meta["split_at"], module_order=meta["module_order"],
                             state_init=blob["state_init"], active_task=meta["active_task"])
        return mh, blob, manifest
    split_at = manifest.get("split_at") or "seg_outputs"
    parts = {t: split_params(blob["heads"][t], split_at, module_order) for t in order}
    mh = MultiHeadParams(body=parts[meta["active_task"]][0],
                         heads=OrderedDict((t, parts[t][1]) for t in order),
                         split_at=split_at, module_order=list(module_order),
                         active_task=meta["active_task"])
    return mh, blob, manifest


def load_checkpoint(path_base: str, device: torch.device):
    """Returns ({task: full state_dict on ``device``}, manifest), from a
    trainer's checkpoint or a model saved by hand."""
    blob, manifest = _read(path_base, device)
    order = manifest["meta"]["task_order"]
    if "body" not in blob:
        return {t: blob["heads"][t] for t in order}, manifest
    return {t: {**blob["body"], **blob["heads"][t]} for t in order}, manifest
