"""Dataset fingerprinting: per-case geometry + foreground intensity statistics.

Equivalent role to upstream nnU-Net's ``DatasetAnalyzer`` (a dependency of the
reference — see SURVEY.md §2.8: the rebuild must provide planning /
preprocessing).  Reads a Decathlon-style task folder::

    TaskXXX_Name/
      dataset.json          # {"modality": {"0": "MRI"}, "labels": {"0": "bg", ...}}
      imagesTr/<case>.nii.gz      (or <case>_0000.nii.gz per-modality files)
      labelsTr/<case>.nii.gz

and produces a fingerprint dict with: case list, per-case shapes/spacings,
class list, and per-modality foreground intensity stats (used for CT
clip+z-score normalization).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from ..utilities.imageio import (READABLE_SUFFIXES, image_suffix,
                                 read_image)


def list_cases(task_dir: str) -> list[str]:
    labels_dir = os.path.join(task_dir, "labelsTr")
    cases = sorted(
        f[: -len(image_suffix(f))]
        for f in os.listdir(labels_dir)
        if image_suffix(f) and not f.startswith(".")
    )
    return cases


def case_image_files(task_dir: str, case: str, num_modalities: int) -> list[str]:
    """Resolve the per-modality image files for a case (``_0000`` suffix style
    or a single 4D/3D file)."""
    images_dir = os.path.join(task_dir, "imagesTr")
    files = []
    for m in range(num_modalities):
        for ext in READABLE_SUFFIXES:
            p = os.path.join(images_dir, f"{case}_{m:04d}{ext}")
            if os.path.isfile(p):
                files.append(p)
                break
    if len(files) == num_modalities:
        return files
    for ext in READABLE_SUFFIXES:
        p = os.path.join(images_dir, f"{case}{ext}")
        if os.path.isfile(p):
            return [p]
    raise FileNotFoundError(f"no image files for case {case} in {images_dir}")


def load_case(task_dir: str, case: str, num_modalities: int):
    """Returns (data [C, X, Y, Z] float32, seg [X, Y, Z] int8 or None, spacing, affine)."""
    files = case_image_files(task_dir, case, num_modalities)
    imgs = [read_image(f) for f in files]
    vols = []
    for img in imgs:
        d = np.asarray(img.data)
        if d.ndim == 4:  # 4D multichannel single file: split channels (last axis = t)
            for c in range(d.shape[3]):
                vols.append(d[..., c].astype(np.float32))
        else:
            vols.append(d.astype(np.float32))
    data = np.stack(vols, axis=0)
    seg = None
    for ext in READABLE_SUFFIXES:
        p = os.path.join(task_dir, "labelsTr", f"{case}{ext}")
        if os.path.isfile(p):
            seg = np.asarray(read_image(p).data).astype(np.int8)
            break
    return data, seg, tuple(imgs[0].spacing), imgs[0].affine


def analyze_dataset(task_dir: str, sample_fg_voxels: int = 10000, seed: int = 1234) -> dict:
    with open(os.path.join(task_dir, "dataset.json")) as f:
        djson = json.load(f)
    modalities = {int(k): v for k, v in djson["modality"].items()}
    labels = {int(k): v for k, v in djson["labels"].items()}
    cases = list_cases(task_dir)
    rng = np.random.RandomState(seed)

    shapes, spacings = {}, {}
    fg_samples = defaultdict(list)  # modality -> intensity samples
    size_reductions = {}
    for case in cases:
        data, seg, spacing, _ = load_case(task_dir, case, len(modalities))
        mask = _nonzero_mask(data)
        bbox = bounding_box(mask)
        cropped_shape = tuple(b[1] - b[0] for b in bbox)
        shapes[case] = cropped_shape
        spacings[case] = spacing
        size_reductions[case] = float(np.prod(cropped_shape) / max(1, np.prod(data.shape[1:])))
        if seg is not None:
            fg = seg > 0
            n_fg = int(fg.sum())
            if n_fg > 0:
                idx = np.flatnonzero(fg.ravel())
                if len(idx) > sample_fg_voxels:
                    idx = rng.choice(idx, sample_fg_voxels, replace=False)
                for m in range(data.shape[0]):
                    fg_samples[m].append(data[m].ravel()[idx])

    intensity_props = {}
    for m in range(len(modalities)):
        if fg_samples[m]:
            v = np.concatenate(fg_samples[m])
            intensity_props[m] = {
                "mean": float(v.mean()),
                "sd": float(v.std()),
                "percentile_00_5": float(np.percentile(v, 0.5)),
                "percentile_99_5": float(np.percentile(v, 99.5)),
                "median": float(np.median(v)),
                "min": float(v.min()),
                "max": float(v.max()),
            }
        else:
            intensity_props[m] = None

    return {
        "task": os.path.basename(task_dir.rstrip("/")),
        "modalities": {int(k): v for k, v in modalities.items()},
        "labels": {int(k): v for k, v in labels.items()},
        "all_classes": sorted(k for k in labels if k > 0),
        "cases": cases,
        "shapes_after_crop": shapes,
        "spacings": spacings,
        "size_reductions": size_reductions,
        "intensity_properties": intensity_props,
    }


def _nonzero_mask(data: np.ndarray) -> np.ndarray:
    """Union over modalities of data != 0 (nnU-Net crop criterion)."""
    mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    return mask


def bounding_box(mask: np.ndarray) -> list[tuple[int, int]]:
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        nz = np.any(mask, axis=other)
        w = np.flatnonzero(nz)
        if len(w) == 0:
            bbox.append((0, mask.shape[ax]))
        else:
            bbox.append((int(w[0]), int(w[-1]) + 1))
    return bbox


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray | None):
    """Crop data [C, ...] (+seg) to the nonzero bbox; returns (data, seg, bbox,
    nonzero_mask_cropped)."""
    mask = _nonzero_mask(data)
    bbox = bounding_box(mask)
    slicer = tuple(slice(b[0], b[1]) for b in bbox)
    data_c = data[(slice(None),) + slicer]
    seg_c = seg[slicer] if seg is not None else None
    return np.ascontiguousarray(data_c), seg_c, bbox, mask[slicer]
