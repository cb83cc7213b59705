"""Experiment planning: derive network topology / patch / batch / spacing from a
dataset fingerprint.

Fills the role of upstream nnU-Net's ExperimentPlanner2D/3D (a required
dependency of the reference, SURVEY.md §2.8) with the same published
algorithm: median target spacing (anisotropy-corrected), iterative pooling
until feature maps are small, patch size from the median resampled shape
shrunk to a compute budget, batch size from the leftover budget capped at 5%
of the dataset's voxels.

TPU-first deviations (documented, deliberate):
  * plans are stored as JSON (``<identifier>_plans.json``) instead of pickle;
    a ``.pkl`` compatibility blob is not needed since the whole stack is ours.
  * patch sizes are rounded to multiples of ``2^num_pool`` per axis (required
    for exact stride-2 up/down sampling) and kept static across tasks — the
    reference freezes the first task's geometry for later tasks
    (``model_restore.py:120-134``); we adopt that as a hard invariant because
    XLA recompiles on shape changes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict

import numpy as np

# Compute budget: voxels of a batch-2 3D input patch that we consider "full".
# Chosen so Task04_Hippocampus-scale datasets get full-volume patches and
# large CT volumes get ~128^3 patches, mirroring nnU-Net v1 outcomes.
BUDGET_VOXELS_3D = 2 * 128 * 128 * 128
BUDGET_VOXELS_2D = 56 * 256 * 256
MAX_POOL_3D = 5
MAX_POOL_2D = 6
MIN_FEATURE_MAP_SIZE = 4
DEFAULT_BATCH_3D = 2
DEFAULT_BATCH_2D = 50
MAX_NUM_FEATURES_3D = 320
MAX_NUM_FEATURES_2D = 512
BASE_NUM_FEATURES = 32


@dataclass
class Configuration:
    """One resolution configuration (2d / 3d_fullres / 3d_lowres)."""
    name: str
    batch_size: int
    patch_size: list          # spatial dims, len 2 or 3
    spacing: list             # target spacing, len 3 (2d: index 0 = through-plane)
    pool_op_kernel_sizes: list   # per pooled stage, per axis strides
    conv_kernel_sizes: list      # per stage (num_pool + 1 entries)
    base_num_features: int = BASE_NUM_FEATURES
    max_num_features: int = MAX_NUM_FEATURES_3D
    do_dummy_2d_aug: bool = False

    @property
    def num_pool_per_axis(self):
        ks = np.array(self.pool_op_kernel_sizes)
        return [int(np.sum(np.log2(ks[:, i]))) for i in range(ks.shape[1])]


@dataclass
class Plans:
    plans_name: str
    task: str
    num_modalities: int
    num_classes: int            # foreground classes (excludes background)
    all_classes: list
    modalities: dict
    labels: dict
    normalization_schemes: dict  # modality index -> 'CT' | 'zscore'
    use_mask_for_norm: dict      # modality index -> bool
    intensity_properties: dict
    original_median_spacing: list
    original_median_shape: list
    transpose_forward: list = field(default_factory=lambda: [0, 1, 2])
    transpose_backward: list = field(default_factory=lambda: [0, 1, 2])
    configurations: dict = field(default_factory=dict)  # name -> Configuration

    def config(self, name: str) -> Configuration:
        key = "3d_fullres" if name == "3d" else name
        return self.configurations[key]

    def save(self, path: str) -> None:
        d = asdict(self)
        with open(path, "w") as f:
            json.dump(d, f, indent=2, default=_json_default)

    @staticmethod
    def load(path: str) -> "Plans":
        with open(path) as f:
            d = json.load(f)
        d["configurations"] = {k: Configuration(**v) for k, v in d["configurations"].items()}
        for key in ("modalities", "labels", "normalization_schemes", "use_mask_for_norm"):
            d[key] = {int(k): v for k, v in d[key].items()}
        d["intensity_properties"] = {int(k): v for k, v in d["intensity_properties"].items()}
        return Plans(**d)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


def compute_target_spacing(fingerprint: dict) -> np.ndarray:
    spacings = np.array([fingerprint["spacings"][c] for c in fingerprint["cases"]], dtype=np.float64)
    target = np.median(spacings, axis=0)
    # Anisotropy rule: an axis >3x the finest axis gets the 10th percentile of
    # its spacings (so we don't upsample extreme low-res axes to the median).
    worst = np.argmax(target)
    others = [i for i in range(3) if i != worst]
    if target[worst] > 3 * min(target[others]) if others else False:
        target[worst] = np.percentile(spacings[:, worst], 10)
        target[worst] = max(target[worst], float(np.min(spacings[:, worst])))
    return target


def median_resampled_shape(fingerprint: dict, target_spacing: np.ndarray) -> np.ndarray:
    shapes = []
    for c in fingerprint["cases"]:
        shp = np.array(fingerprint["shapes_after_crop"][c], dtype=np.float64)
        sp = np.array(fingerprint["spacings"][c], dtype=np.float64)
        shapes.append(shp * sp / target_spacing)
    return np.round(np.median(np.array(shapes), axis=0)).astype(np.int64)


def pool_and_conv_topology(patch_size, spacing, max_pool, min_fmap=MIN_FEATURE_MAP_SIZE):
    """Iteratively pool the currently-finest axes (within 2x of the min
    spacing) while feature maps stay >= min_fmap.  Conv kernel per axis is 1
    while that axis' spacing is >2x the finest (anisotropic), 3 afterwards.
    Returns (pool_kernels, conv_kernels, final_patch_size).
    """
    dim = len(patch_size)
    size = np.array(patch_size, dtype=np.int64)
    sp = np.array(spacing, dtype=np.float64)
    pools, convs = [], []
    convs.append([1 if sp[a] > 2.5 * sp.min() else 3 for a in range(dim)])
    for _ in range(max_pool):
        eligible = [a for a in range(dim)
                    if size[a] >= 2 * min_fmap and sp[a] <= 2.0 * sp.min()]
        if not eligible:
            # allow coarser axes to catch up if nothing else can pool
            eligible = [a for a in range(dim) if size[a] >= 2 * min_fmap]
            if not eligible:
                break
            eligible = [a for a in eligible if sp[a] <= 2.0 * min(sp[e] for e in eligible)]
        stride = [2 if a in eligible else 1 for a in range(dim)]
        pools.append(stride)
        for a in eligible:
            size[a] = -(-size[a] // 2)
            sp[a] *= 2
        convs.append([1 if sp[a] > 2.5 * sp.min() else 3 for a in range(dim)])
    # round patch up to a multiple of the total stride per axis
    total_stride = np.prod(np.array(pools), axis=0) if pools else np.ones(dim, dtype=np.int64)
    return pools, convs, total_stride.astype(np.int64)


def _fit_patch(median_shape, spacing, budget, max_pool, default_batch, dim):
    patch = np.array(median_shape, dtype=np.int64).copy()
    patch = np.maximum(patch, 2 * MIN_FEATURE_MAP_SIZE)
    while int(np.prod(patch)) * default_batch > budget:
        # shrink the axis largest relative to the median shape (nnU-Net rule)
        rel = patch / np.maximum(np.array(median_shape, np.float64), 1.0)
        ax = int(np.argmax(rel)) if rel.max() > rel.min() else int(np.argmax(patch))
        patch[ax] = max(2 * MIN_FEATURE_MAP_SIZE, int(patch[ax] * 0.9))
    pools, convs, total_stride = pool_and_conv_topology(patch, spacing, max_pool)
    patch = (-(-patch // total_stride)) * total_stride  # round up to stride multiple
    return patch, pools, convs


def determine_transpose(target_spacing) -> tuple:
    """nnU-Net axis-reorder rule (upstream ExperimentPlanner, required by the
    reference's plans surgery at ``inference/predict.py:224-226,354-362``):
    the COARSEST axis goes first, the rest keep relative order.  All plans
    quantities (patch/pool/spacing) and preprocessed arrays live in this
    transposed space; predictions are un-transposed at restore time."""
    worst = int(np.argmax(target_spacing))
    tf = [worst] + [i for i in range(len(target_spacing)) if i != worst]
    tb = [int(x) for x in np.argsort(tf)]
    return tf, tb


def plan_experiment(fingerprint: dict, plans_name: str = "nnUNetPlansv2.1") -> Plans:
    target_spacing = compute_target_spacing(fingerprint)
    median_shape = median_resampled_shape(fingerprint, target_spacing)
    transpose_forward, transpose_backward = determine_transpose(target_spacing)
    # everything below (patch/pool/conv/spacing) is in TRANSPOSED axis order
    target_spacing = target_spacing[transpose_forward]
    median_shape = median_shape[transpose_forward]
    total_voxels = float(np.sum([np.prod(fingerprint["shapes_after_crop"][c])
                                 for c in fingerprint["cases"]]))

    norm_schemes, use_mask = {}, {}
    for m, name in fingerprint["modalities"].items():
        is_ct = str(name).upper() in ("CT", "CTA")
        norm_schemes[m] = "CT" if is_ct else "zscore"
        # nnU-Net: use nonzero mask for norm when cropping shrank volumes a lot
        med_reduction = float(np.median(list(fingerprint["size_reductions"].values())))
        use_mask[m] = (not is_ct) and med_reduction < 0.75

    configurations = {}

    # --- 3d_fullres ---
    patch3, pools3, convs3 = _fit_patch(median_shape, target_spacing,
                                        BUDGET_VOXELS_3D, MAX_POOL_3D, DEFAULT_BATCH_3D, 3)
    vox3 = int(np.prod(patch3))
    batch3 = max(DEFAULT_BATCH_3D, int(BUDGET_VOXELS_3D / max(vox3, 1)))
    batch3 = max(DEFAULT_BATCH_3D, min(batch3, max(2, int(0.05 * total_voxels / max(vox3, 1)))))
    configurations["3d_fullres"] = Configuration(
        name="3d_fullres", batch_size=int(batch3), patch_size=[int(x) for x in patch3],
        spacing=[float(s) for s in target_spacing],
        pool_op_kernel_sizes=pools3, conv_kernel_sizes=convs3,
        max_num_features=MAX_NUM_FEATURES_3D,
        do_dummy_2d_aug=bool(target_spacing.max() / target_spacing.min() > 3),
    )

    # --- 2d --- (slices along the coarsest axis)
    axis0 = int(np.argmax(target_spacing))
    inplane = [i for i in range(3) if i != axis0]
    median2 = median_shape[inplane]
    sp2 = target_spacing[inplane]
    patch2, pools2, convs2 = _fit_patch(median2, sp2, BUDGET_VOXELS_2D, MAX_POOL_2D, DEFAULT_BATCH_2D, 2)
    vox2 = int(np.prod(patch2))
    batch2 = max(DEFAULT_BATCH_2D, int(BUDGET_VOXELS_2D / max(vox2, 1)))
    batch2 = min(batch2, max(2, int(0.05 * total_voxels / max(vox2, 1))))
    batch2 = max(batch2, 2)
    sp2_full = [float(target_spacing[axis0])] + [float(s) for s in sp2]
    configurations["2d"] = Configuration(
        name="2d", batch_size=int(batch2), patch_size=[int(x) for x in patch2],
        spacing=sp2_full, pool_op_kernel_sizes=pools2, conv_kernel_sizes=convs2,
        max_num_features=MAX_NUM_FEATURES_2D,
    )

    # --- 3d_lowres --- only when the median volume is much larger than the patch
    median_vox = float(np.prod(median_shape))
    if median_vox > 4 * vox3:
        shrink = (median_vox / (2 * vox3)) ** (1 / 3)
        lowres_spacing = target_spacing * shrink
        lowres_shape = np.round(median_shape / shrink).astype(np.int64)
        patchl, poolsl, convsl = _fit_patch(lowres_shape, lowres_spacing,
                                            BUDGET_VOXELS_3D, MAX_POOL_3D, DEFAULT_BATCH_3D, 3)
        configurations["3d_lowres"] = Configuration(
            name="3d_lowres", batch_size=DEFAULT_BATCH_3D,
            patch_size=[int(x) for x in patchl],
            spacing=[float(s) for s in lowres_spacing],
            pool_op_kernel_sizes=poolsl, conv_kernel_sizes=convsl,
            max_num_features=MAX_NUM_FEATURES_3D,
        )

    return Plans(
        plans_name=plans_name,
        task=fingerprint["task"],
        num_modalities=len(fingerprint["modalities"]),
        num_classes=len(fingerprint["all_classes"]),
        all_classes=list(fingerprint["all_classes"]),
        modalities=fingerprint["modalities"],
        labels=fingerprint["labels"],
        normalization_schemes=norm_schemes,
        use_mask_for_norm=use_mask,
        intensity_properties=fingerprint["intensity_properties"],
        original_median_spacing=[float(s) for s in np.median(
            np.array([fingerprint["spacings"][c] for c in fingerprint["cases"]]), axis=0)],
        original_median_shape=[int(x) for x in median_shape],
        transpose_forward=transpose_forward,
        transpose_backward=transpose_backward,
        configurations=configurations,
    )


def plans_path(preprocessed_task_dir: str, identifier: str = "nnUNetPlansv2.1") -> str:
    return os.path.join(preprocessed_task_dir, f"{identifier}_plans.json")
