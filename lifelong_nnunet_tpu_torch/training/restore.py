"""Model restoration from a port checkpoint: the inference subset of
``lifelong_nnunet_tpu/training/restore.py``.

The manifest embeds the full plans (the first task's, so later tasks never
reshape the network) and the network widths; ``restore_model`` rebuilds the
U-Net from them and loads one task's head.
"""

from __future__ import annotations

import os

import torch

from ..device import compute_dtype
from ..models.unet import GenericUNet, unet_from_plans
from ..planning.plans import Configuration, Plans
from .checkpoints import CKPT_SUFFIX, load_checkpoint


def plans_from_manifest(manifest: dict) -> Plans:
    d = dict(manifest["plans"])
    d["configurations"] = {k: Configuration(**v) for k, v in d["configurations"].items()}
    for key in ("modalities", "labels", "normalization_schemes", "use_mask_for_norm"):
        d[key] = {int(k): v for k, v in d[key].items()}
    d["intensity_properties"] = {int(k): v for k, v in d["intensity_properties"].items()}
    return Plans(**d)


def find_checkpoint(folder: str, prefer: str = "model_final_checkpoint") -> str | None:
    for name in (prefer, "model_latest", "model_best"):
        base = os.path.join(folder, name)
        if os.path.isfile(base + CKPT_SUFFIX):
            return base
    return None


def restore_model(checkpoint_base: str, device: torch.device, head: str | None = None,
                  use_kernels: bool = True):
    """checkpoint_base: path WITHOUT extension.  Returns (GenericUNet on
    ``device`` in eval mode with ``head`` loaded — default the last task —,
    plans, config_name).  The activation dtype follows the device; only the
    full-resolution head runs (inference).  ``use_kernels=False`` gives the
    plain route (``models/unet.py``)."""
    heads, manifest = load_checkpoint(checkpoint_base, device)
    if manifest.get("use_vit"):
        raise NotImplementedError("the ViT-U-Net is not ported yet")
    plans = plans_from_manifest(manifest)
    config_name = manifest["config_name"]
    head = head or manifest["meta"]["task_order"][-1]
    if head not in heads:
        raise KeyError(f"no head {head!r} in {checkpoint_base}: {list(heads)}")
    model: GenericUNet = unet_from_plans(
        plans, config_name, dtype=compute_dtype(device),
        deep_supervision=False, use_kernels=use_kernels,
        base_num_features=manifest.get("base_num_features"),
        max_num_features=manifest.get("max_num_features"))
    model.load_state_dict(heads[head])
    return model.to(device).eval(), plans, config_name
