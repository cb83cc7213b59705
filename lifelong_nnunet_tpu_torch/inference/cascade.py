"""The 3d_lowres -> 3d_fullres cascade stage: the port of
``lifelong_nnunet_tpu/inference/cascade.py``.

``prepare_cascade_stage`` serves a trained 3d_lowres model over every
preprocessed lowres case (segmentation out, bfloat16-rounded input, as the
JAX package does), zooms each foreground class's mask to the matching
fullres case's grid (``ndimage.zoom`` order 1, ``mode="nearest"``, crop or
zero-pad, ``> 0.5``) and writes the fullres case with those one-hot masks
appended as input channels (``[C + num_fg, *spatial]`` + seg, float32),
beside copies of its ``.props.json`` and ``.classlocs.npz``.
``CascadeFullResTrainer`` trains the fullres model on such a stage with
``num_modalities + num_fg`` input channels; it is trained through the
trainer API (``train_task``), as in the JAX package, which has no training
CLI for it either.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from scipy import ndimage

from ..data.dataset import PreprocessedDataset
from ..training.restore import restore_model
from ..training.trainers.sequential import SequentialTrainer
from .sliding_window import predict_sliding_window


def prepare_cascade_stage(lowres_ckpt_base: str, lowres_stage_dir: str,
                          fullres_stage_dir: str, out_stage_dir: str,
                          window_batch: int = 8, do_tta: bool = False, *,
                          device: torch.device) -> list:
    """Serve the lowres checkpoint (its active task's head, on ``device``)
    over every case of ``fullres_stage_dir`` that ``lowres_stage_dir`` also
    holds, and write the augmented cases into ``out_stage_dir``.  Returns
    the cases written, in the fullres stage's order."""
    with open(lowres_ckpt_base + ".json") as f:
        manifest = json.load(f)
    model, plans, _ = restore_model(lowres_ckpt_base, device,
                                    head=manifest["meta"]["active_task"])
    patch = getattr(model, "patch_size", manifest["patch_size"])
    num_classes = plans.num_classes + 1
    low = PreprocessedDataset(lowres_stage_dir)
    full = PreprocessedDataset(fullres_stage_dir)
    os.makedirs(out_stage_dir, exist_ok=True)
    written = []
    for case in full.cases:
        if case not in low.cases:
            continue
        low_arr = np.asarray(low.load(case))
        seg_pred = predict_sliding_window(
            model, np.moveaxis(low_arr[:-1], 0, -1), patch, num_classes, device=device,
            mirror_axes=(0, 1, 2) if do_tta else (), window_batch=window_batch,
            output="seg", input_bf16=True)
        full_arr = np.asarray(full.load(case))
        full_shape = full_arr.shape[1:]
        zoom = np.array(full_shape) / np.array(seg_pred.shape)
        onehots = []
        for c in range(1, num_classes):   # foreground classes only (nnU-Net)
            m = ndimage.zoom((seg_pred == c).astype(np.float32), zoom, order=1,
                             mode="nearest")
            m = m[tuple(slice(0, s) for s in full_shape)]
            m = np.pad(m, [(0, s - m.shape[i]) for i, s in enumerate(full_shape)])
            onehots.append((m > 0.5).astype(np.float32))
        stacked = np.concatenate([full_arr[:-1], np.stack(onehots), full_arr[-1:]],
                                 axis=0).astype(np.float32)
        np.save(os.path.join(out_stage_dir, f"{case}.npy"), stacked)
        for suffix in (".props.json", ".classlocs.npz"):
            src = os.path.join(fullres_stage_dir, case + suffix)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(out_stage_dir, case + suffix))
        written.append(case)
    return written


class CascadeFullResTrainer(SequentialTrainer):
    """The fullres cascade stage's trainer: a Sequential trainer on a stage
    that ``prepare_cascade_stage`` wrote (modalities + the lowres stage's
    one-hot foreground channels).  The reference's
    ``nnViTUNetTrainer_CascadeFullRes``."""
    EXTENSION = "cascade_fullres"

    @classmethod
    def input_channels(cls, plans) -> int:
        return plans.num_modalities + plans.num_classes
