"""Synthetic Decathlon-style dataset generator (the port's copy of
``tests/synthetic.py``, written through the port's NIfTI writer).

Produces small 3D MRI-like volumes containing two labeled structures (an
ellipsoid = class 1 with a brighter core = class 2) so that segmentation is
learnable by a small U-Net in a few hundred steps — the test-tier stand-in
for Task04_Hippocampus (SURVEY.md §4)."""

from __future__ import annotations

import json
import os

import numpy as np

from .nifti import NiftiImage, write


def _make_case(rng: np.random.RandomState, shape, intensity_shift=0.0):
    img = rng.normal(0.1, 0.05, size=shape).astype(np.float32)
    seg = np.zeros(shape, dtype=np.uint8)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    center = np.array(shape) / 2 + rng.uniform(-3, 3, size=3)
    radii = np.array(shape) * rng.uniform(0.18, 0.28, size=3)
    d = (((zz - center[0]) / radii[0]) ** 2 + ((yy - center[1]) / radii[1]) ** 2
         + ((xx - center[2]) / radii[2]) ** 2)
    body = d < 1.0
    core = d < 0.25
    img[body] += 0.5 + intensity_shift
    img[core] += 0.4
    seg[body] = 1
    seg[core] = 2
    img += rng.normal(0, 0.03, size=shape).astype(np.float32)
    # zero border so crop-to-nonzero has work to do
    img = np.pad(img[2:-2, 2:-2, 2:-2], 2, mode="constant")
    seg[:2] = 0; seg[-2:] = 0
    return np.abs(img).astype(np.float32), seg


def _ellipsoid_dist(shape, rng, center_jitter=3.0, rad_lo=0.18, rad_hi=0.28,
                    center=None, radii=None):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    if center is None:
        center = np.array(shape) / 2 + rng.uniform(-center_jitter,
                                                   center_jitter, size=3)
    if radii is None:
        radii = np.array(shape) * rng.uniform(rad_lo, rad_hi, size=3)
    return (((zz - center[0]) / radii[0]) ** 2
            + ((yy - center[1]) / radii[1]) ** 2
            + ((xx - center[2]) / radii[2]) ** 2)


def _rand_center(shape, rng, margin=0.22):
    return np.array([rng.uniform(margin * s, (1 - margin) * s) for s in shape])


def _make_case_shells(rng: np.random.RandomState, shape):
    """Task style 'shells': thin HOLLOW surfaces are foreground; compact
    BRIGHT blobs are explicit background distractors.  The discriminative
    feature is surface-ness at small scale — structurally disjoint from the
    'blobs' task, and the bright-compact cue is actively anti-correlated
    with it (the source of forgetting, VERDICT r3 next #3)."""
    img = rng.normal(0.35, 0.05, size=shape).astype(np.float32)
    seg = np.zeros(shape, dtype=np.uint8)
    d = _ellipsoid_dist(shape, rng, rad_lo=0.28, rad_hi=0.36)
    shell = np.abs(np.sqrt(d) - 1.0) < 0.10          # thin outer shell
    inner = np.abs(np.sqrt(d) - 0.45) < 0.14         # thin inner shell
    img[shell] += 0.5
    img[inner] += 0.5
    seg[shell] = 1
    seg[inner] = 2
    # bright compact distractors labeled BACKGROUND (conflict with 'blobs')
    for _ in range(rng.randint(2, 4)):
        dd = _ellipsoid_dist(shape, rng, center=_rand_center(shape, rng),
                             radii=np.array(shape) * rng.uniform(0.06, 0.10,
                                                                 size=3))
        blob = (dd < 1.0) & (seg == 0)
        img[blob] += 0.55
    img += rng.normal(0, 0.03, size=shape).astype(np.float32)
    img = np.pad(img[2:-2, 2:-2, 2:-2], 2, mode="constant")
    seg[:2] = 0; seg[-2:] = 0
    return np.abs(img).astype(np.float32), seg


def _make_case_dark_multi(rng: np.random.RandomState, shape):
    """Task style 'dark_multi': multiple small HYPOintense components are
    foreground on a bright background, while compact BRIGHT blobs are
    background distractors — the intensity-polarity INVERSE of 'blobs'
    (z-scoring preserves contrast polarity, so the conflict survives
    normalization)."""
    img = rng.normal(0.75, 0.05, size=shape).astype(np.float32)
    seg = np.zeros(shape, dtype=np.uint8)
    # 3-4 small dark blobs = class 1 (radii >=0.10 of the volume so each
    # blob spans >=3 voxels at the 28-voxel test scale — smaller blobs are
    # unlearnable at patch 16^3 and task C self-dice collapses)
    for _ in range(rng.randint(3, 5)):
        dd = _ellipsoid_dist(shape, rng, center=_rand_center(shape, rng),
                             radii=np.array(shape) * rng.uniform(0.10, 0.14,
                                                                 size=3))
        blob = dd < 1.0
        img[blob] -= 0.45
        seg[blob] = 1
    # one medium dark blob with darker core = class 2
    dd = _ellipsoid_dist(shape, rng, center=_rand_center(shape, rng, 0.3),
                         radii=np.array(shape) * rng.uniform(0.14, 0.18,
                                                             size=3))
    blob = dd < 1.0
    img[blob] = np.float32(0.35)
    img[dd < 0.3] = np.float32(0.2)
    seg[blob] = 2
    # bright compact distractors labeled BACKGROUND (conflict with 'blobs')
    for _ in range(rng.randint(2, 4)):
        dd = _ellipsoid_dist(shape, rng, center=_rand_center(shape, rng),
                             radii=np.array(shape) * rng.uniform(0.06, 0.10,
                                                                 size=3))
        blob = (dd < 1.0) & (seg == 0)
        img[blob] += 0.45
    img += rng.normal(0, 0.03, size=shape).astype(np.float32)
    img = np.pad(img[2:-2, 2:-2, 2:-2], 2, mode="constant")
    seg[:2] = 0; seg[-2:] = 0
    return np.abs(img).astype(np.float32), seg


CASE_STYLES = {
    "blobs": _make_case,
    "shells": lambda rng, shape, intensity_shift=0.0: _make_case_shells(rng, shape),
    "dark_multi": lambda rng, shape, intensity_shift=0.0: _make_case_dark_multi(rng, shape),
}


def make_synthetic_task(root: str, task_name="Task097_SynthA", num_cases=6, seed=0,
                        shape=(28, 36, 28), spacing=(1.0, 1.0, 1.0), intensity_shift=0.0,
                        style="blobs"):
    make_case = CASE_STYLES[style]
    rng = np.random.RandomState(seed)
    task_dir = os.path.join(root, task_name)
    os.makedirs(os.path.join(task_dir, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(task_dir, "labelsTr"), exist_ok=True)
    os.makedirs(os.path.join(task_dir, "imagesTs"), exist_ok=True)
    cases = []
    for i in range(num_cases):
        case = f"synth_{i:03d}"
        img, seg = make_case(rng, shape, intensity_shift=intensity_shift)
        write(os.path.join(task_dir, "imagesTr", f"{case}_0000.nii.gz"),
              NiftiImage(img, spacing=spacing))
        write(os.path.join(task_dir, "labelsTr", f"{case}.nii.gz"),
              NiftiImage(seg, spacing=spacing))
        cases.append(case)
    djson = {
        "name": task_name,
        "modality": {"0": "MRI"},
        "labels": {"0": "background", "1": "body", "2": "core"},
        "numTraining": num_cases,
        "training": [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                     for c in cases],
    }
    with open(os.path.join(task_dir, "dataset.json"), "w") as f:
        json.dump(djson, f)
    return task_dir
