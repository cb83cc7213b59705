"""Model and trainer restoration from a port checkpoint: the port of
``lifelong_nnunet_tpu/training/restore.py``.

The manifest embeds the full plans (the first task's, so later tasks never
reshape the network), the network widths and, for a ViT-U-Net, its
``vit`` options and the patch size its position embeddings were sized for;
``restore_model`` rebuilds the U-Net or the ViT-U-Net from them and loads
one task's head (a ViT-U-Net keeps that patch as ``model.patch_size``,
which serving windows with); ``restore_trainer`` rebuilds the trainer of
the manifest's class with the registry, epoch and step, and the optimizer
when asked.

:func:`route_switches` reads the JAX package's two switches for the
CT-scale routes, as its ``maybe_pallas_conv`` does for served models and
its trainer for trained ones: ``LNN_BLOCKED_CONV=1`` (the blocked conv) and
``LNN_UPT_MODE=pallas`` (the interleave upsample).  Nothing under
``models/`` or ``ops/`` reads the environment.
"""

from __future__ import annotations

import copy
import json
import os

import torch

from ..device import compute_dtype
from ..models.unet import GenericUNet, unet_from_plans
from ..models.vit_unet import vit_overrides, vit_unet_from_plans
from ..planning.plans import Configuration, Plans
from .checkpoints import CKPT_SUFFIX, load_checkpoint


def plans_from_manifest(manifest: dict) -> Plans:
    d = dict(manifest["plans"])
    d["configurations"] = {k: Configuration(**v) for k, v in d["configurations"].items()}
    for key in ("modalities", "labels", "normalization_schemes", "use_mask_for_norm"):
        d[key] = {int(k): v for k, v in d[key].items()}
    d["intensity_properties"] = {int(k): v for k, v in d["intensity_properties"].items()}
    return Plans(**d)


def route_switches() -> dict:
    """``blocked_conv`` / ``upsample`` from ``LNN_BLOCKED_CONV`` and
    ``LNN_UPT_MODE`` (off unless set to ``1`` / ``pallas``; the JAX package's
    other upsample modes have no route in the port)."""
    return {"blocked_conv": os.environ.get("LNN_BLOCKED_CONV", "0") == "1",
            "upsample": "interleave" if os.environ.get("LNN_UPT_MODE") == "pallas"
            else "direct"}


def find_checkpoint(folder: str, prefer: str = "model_final_checkpoint") -> str | None:
    for name in (prefer, "model_latest", "model_best"):
        base = os.path.join(folder, name)
        if os.path.isfile(base + CKPT_SUFFIX):
            return base
    return None


def model_from_manifest(manifest: dict, plans: Plans, **kwargs) -> GenericUNet:
    """The network a manifest describes (the JAX ``restore_trainer``'s model
    rules, ``restore.py:45-66``), built with ``kwargs`` (dtype, deep
    supervision, routes, generator)."""
    widths = dict(base_num_features=manifest.get("base_num_features"),
                  max_num_features=manifest.get("max_num_features"), **kwargs)
    vit = manifest.get("vit")
    if not (manifest.get("use_vit") and vit):
        return unet_from_plans(plans, manifest["config_name"], **widths)
    if vit.get("ln_tasks") or vit.get("task_specific_ln"):
        raise NotImplementedError("task-specific LayerNorms are not ported yet")
    return vit_unet_from_plans(
        plans, manifest["config_name"], manifest.get("patch_size"),
        vit_version=vit["version"], vit_type=vit["type"], lsa=vit["lsa"], spt=vit["spt"],
        **widths, **vit_overrides(vit.get("depth_override")))


def restore_model(checkpoint_base: str, device: torch.device, head: str | None = None,
                  use_kernels: bool = True, routes: dict | None = None):
    """checkpoint_base: path WITHOUT extension.  Returns (GenericUNet or
    GenericViTUNet on ``device`` in eval mode with ``head`` loaded — default
    the last task —, plans, config_name).  The activation dtype follows the
    device; only the full-resolution head runs (inference).
    ``use_kernels=False`` gives the plain route (``models/unet.py``);
    ``routes`` (``blocked_conv`` / ``upsample``) default to
    :func:`route_switches`."""
    heads, manifest = load_checkpoint(checkpoint_base, device)
    plans = plans_from_manifest(manifest)
    head = head or manifest["meta"]["task_order"][-1]
    if head not in heads:
        raise KeyError(f"no head {head!r} in {checkpoint_base}: {list(heads)}")
    model = model_from_manifest(manifest, plans, dtype=compute_dtype(device),
                                deep_supervision=False, use_kernels=use_kernels,
                                **(route_switches() if routes is None else routes))
    model.load_state_dict(heads[head])
    return model.to(device).eval(), plans, manifest["config_name"]


def restore_trainer(checkpoint_base: str, options=None, restore_opt: bool = False):
    """checkpoint_base: path WITHOUT extension.  A trainer of the manifest's
    class on ``options.device`` (``options`` is copied, then given the
    manifest's fold, split, patch, batch, widths and ViT options) with the
    manifest's hyperparameters, its registry, epoch, global step and
    ``cl_state`` (EWC's fisher and anchors, RW's running state) restored,
    and the optimizer with ``restore_opt``; its output folder is the
    checkpoint's."""
    # the trainer imports route_switches from here
    from .trainer import TrainerOptions
    from .trainers import get_trainer

    with open(checkpoint_base + ".json") as f:
        manifest = json.load(f)
    cls = get_trainer(manifest["extension"])
    opts = copy.copy(options) if options else TrainerOptions()
    opts.fold = manifest.get("fold", opts.fold)
    opts.split_at = manifest.get("split_at") or opts.split_at
    if manifest.get("patch_size"):
        opts.patch_size = tuple(manifest["patch_size"])
    if manifest.get("batch_size"):
        opts.batch_size = manifest["batch_size"]
    opts.base_num_features = manifest.get("base_num_features") or opts.base_num_features
    opts.max_num_features = manifest.get("max_num_features") or opts.max_num_features
    vit = manifest.get("vit")
    if manifest.get("use_vit") and vit:
        if vit.get("ln_tasks") or vit.get("task_specific_ln"):
            raise NotImplementedError("task-specific LayerNorms are not ported yet")
        opts.use_vit = True
        opts.vit_version, opts.vit_type = vit["version"], vit["type"]
        opts.vit_lsa, opts.vit_spt = vit["lsa"], vit["spt"]
        opts.vit_depth_override = vit.get("depth_override")
    trainer = cls(plans_from_manifest(manifest), manifest["config_name"],
                  os.path.dirname(checkpoint_base), opts,
                  **_parse_hyperparams(cls, manifest.get("hyperparams", {})))
    trainer.load_checkpoint(os.path.basename(checkpoint_base), restore_opt=restore_opt)
    return trainer


def _parse_hyperparams(cls, raw: dict) -> dict:
    """The manifest's stringified hyperparameters, typed by the class's
    ``HYPERPARAMS`` (str where it names none)."""
    out = {}
    for k, v in raw.items():
        typ = cls.HYPERPARAMS.get(k, str)
        try:
            out[k] = str(v).lower() in ("true", "1") if typ is bool else typ(v)
        except (TypeError, ValueError):
            out[k] = v
    return out
