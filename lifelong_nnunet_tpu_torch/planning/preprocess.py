"""Preprocessing: crop-to-nonzero → resample to target spacing → normalize →
write training-ready arrays.

Provides the upstream nnU-Net preprocessing the reference depends on
(SURVEY.md §2.8: crop-to-nonzero, target-spacing resampling, CT clip+z-score /
MR z-score).  Runs on CPU with numpy/scipy (one-time, I/O bound); the training
path consumes the resulting memmap-able ``.npy`` files.

Per case we write::

    <out>/<case>.npy          float32 [C+1, X, Y, Z]  (last channel = seg, -1 padded outside mask)
    <out>/<case>.props.json   geometry needed to undo preprocessing at inference
    <out>/<case>.classlocs.npz  sampled foreground voxel coords per class
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy import ndimage

from .fingerprint import crop_to_nonzero, load_case
from .plans import Plans

ANISO_THRESHOLD = 3.0
MAX_CLASS_LOC_SAMPLES = 10000


def resample_image(data: np.ndarray, spacing, new_spacing, is_seg: bool, order: int = 3):
    """Resample [C, X, Y, Z] data.  Anisotropic volumes (>3x spacing ratio) are
    resampled in-plane with ``order`` and along the coarse axis with
    nearest/linear, as in nnU-Net.  Segmentations resample each class' mask
    with order-1 then argmax (smooth boundaries without label bleeding)."""
    spacing = np.asarray(spacing, dtype=np.float64)
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    shape = np.array(data.shape[1:], dtype=np.float64)
    new_shape = np.round(shape * spacing / new_spacing).astype(np.int64)
    new_shape = np.maximum(new_shape, 1)
    if np.all(new_shape == shape.astype(np.int64)):
        return data.copy()
    zoom = new_shape / shape

    def _zoom_one(vol, o):
        aniso = spacing.max() / spacing.min() > ANISO_THRESHOLD
        if aniso and o > 1:
            ax = int(np.argmax(spacing))
            inplane = [a for a in range(3) if a != ax]
            z_in = np.ones(3); z_in[inplane] = zoom[inplane]
            out = ndimage.zoom(vol, z_in, order=o, mode="nearest")
            if zoom[ax] != 1.0:
                z_ax = np.ones(3); z_ax[ax] = new_shape[ax] / out.shape[ax]
                out = ndimage.zoom(out, z_ax, order=0, mode="nearest")
            return out
        return ndimage.zoom(vol, zoom, order=o, mode="nearest")

    if is_seg:
        seg = data[0]
        labels = np.unique(seg)
        out = np.zeros(tuple(new_shape), dtype=np.float32)
        best = np.full(tuple(new_shape), -np.inf, dtype=np.float32)
        for lab in labels:
            m = _zoom_one((seg == lab).astype(np.float32), 1)
            upd = m > best
            out[upd] = lab
            best[upd] = m[upd]
        return out[None].astype(data.dtype)
    chans = [_zoom_one(data[c].astype(np.float64), order).astype(np.float32)
             for c in range(data.shape[0])]
    # guard against tiny shape mismatches from separate-axis zoom
    chans = [c[tuple(slice(0, s) for s in new_shape)] for c in chans]
    return np.stack(chans, axis=0)


def normalize(data: np.ndarray, plans: Plans, nonzero_mask: np.ndarray | None):
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        scheme = plans.normalization_schemes.get(c, "zscore")
        x = data[c].astype(np.float32)
        if scheme == "CT":
            props = plans.intensity_properties.get(c)
            if props:
                x = np.clip(x, props["percentile_00_5"], props["percentile_99_5"])
                x = (x - props["mean"]) / max(props["sd"], 1e-8)
            else:
                x = (x - x.mean()) / max(x.std(), 1e-8)
        else:
            if plans.use_mask_for_norm.get(c, False) and nonzero_mask is not None:
                m = nonzero_mask
                mean, std = float(x[m].mean()), float(x[m].std())
                x = (x - mean) / max(std, 1e-8)
                x[~m] = 0.0
            else:
                x = (x - x.mean()) / max(x.std(), 1e-8)
        out[c] = x
    return out


def sample_class_locations(seg: np.ndarray, classes, rng: np.random.RandomState):
    locs = {}
    for cls in classes:
        coords = np.argwhere(seg == cls)
        if len(coords) == 0:
            continue
        if len(coords) > MAX_CLASS_LOC_SAMPLES:
            coords = coords[rng.choice(len(coords), MAX_CLASS_LOC_SAMPLES, replace=False)]
        locs[int(cls)] = coords.astype(np.int32)
    return locs


def preprocess_case(task_dir: str, case: str, plans: Plans, config_name: str,
                    out_dir: str, seed: int = 1234) -> dict:
    cfg = plans.config(config_name)
    data, seg, spacing, affine = load_case(task_dir, case, plans.num_modalities)
    orig_shape = data.shape[1:]
    orig_spacing = list(spacing)
    # reorder axes to plans space (coarsest first) — patch/pool geometry and
    # every downstream array live in this order; restore_softmax un-transposes
    tf = list(getattr(plans, "transpose_forward", [0, 1, 2]))
    if tf != [0, 1, 2]:
        data = np.ascontiguousarray(data.transpose([0] + [a + 1 for a in tf]))
        if seg is not None:
            seg = np.ascontiguousarray(seg.transpose(tf))
        spacing = [spacing[a] for a in tf]
    data, seg, bbox, mask = crop_to_nonzero(data, seg)
    target_spacing = np.array(cfg.spacing[-3:], dtype=np.float64)
    data_r = resample_image(data, spacing, target_spacing, is_seg=False)
    if seg is not None:
        seg_r = resample_image(seg[None].astype(np.float32), spacing, target_spacing,
                               is_seg=True)[0].astype(np.int8)
    else:
        seg_r = np.zeros(data_r.shape[1:], dtype=np.int8)
    mask_r = resample_image(mask[None].astype(np.float32), spacing, target_spacing,
                            is_seg=True)[0] > 0.5
    data_n = normalize(data_r, plans, mask_r)
    # nnU-Net marks outside-mask voxels in seg with -1 (used for masked norm/loss)
    seg_out = seg_r.astype(np.int8)
    seg_out[~mask_r & (seg_out == 0)] = -1

    stacked = np.concatenate([data_n, seg_out[None].astype(np.float32)], axis=0)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{case}.npy"), stacked)
    rng = np.random.RandomState(seed)
    locs = sample_class_locations(seg_r, plans.all_classes, rng)
    np.savez_compressed(os.path.join(out_dir, f"{case}.classlocs.npz"),
                        **{str(k): v for k, v in locs.items()})
    props = {
        "case": case,
        "original_shape": [int(x) for x in orig_shape],   # untransposed
        "original_spacing": [float(s) for s in orig_spacing],
        "transpose_forward": tf,                          # bbox/shapes below are in tf space
        "crop_bbox": [[int(b[0]), int(b[1])] for b in bbox],
        "resampled_shape": [int(x) for x in data_r.shape[1:]],
        "target_spacing": [float(s) for s in target_spacing],
        "affine": np.asarray(affine).tolist(),
        "classes_present": sorted(int(c) for c in np.unique(seg_r) if c > 0),
    }
    with open(os.path.join(out_dir, f"{case}.props.json"), "w") as f:
        json.dump(props, f)
    return props


def preprocess_task(task_dir: str, plans: Plans, preprocessed_root: str,
                    configs=("3d_fullres", "2d"), data_identifier: str = "nnUNetData_plans_v2.1"):
    """Preprocess every case for each configuration. Returns output dirs.

    The output tree is keyed by the task actually being preprocessed (the
    ``task_dir`` basename), NOT ``plans.task``: under the first-task geometry
    invariant, later tasks are preprocessed with the FIRST task's plans
    (reference ``model_restore.py:120-134``), and keying by ``plans.task``
    would silently overwrite every task's arrays into one directory (same
    case ids → cross-task aliasing; caught by the round-4 forgetting
    benchmark, where it flattened the [stage x task] Dice matrix)."""
    from .fingerprint import list_cases
    task = os.path.basename(os.path.normpath(task_dir)) or plans.task
    out_dirs = {}
    for cname in configs:
        if cname not in plans.configurations:
            continue
        stage_dir = os.path.join(preprocessed_root, task, f"{data_identifier}_{cname}")
        for case in list_cases(task_dir):
            preprocess_case(task_dir, case, plans, cname, stage_dir)
        out_dirs[cname] = stage_dir
    return out_dirs
