"""Image-in -> segmentation-out prediction: the port of
``lifelong_nnunet_tpu/inference/predict.py``.

Per case: preprocess (crop / resample / normalize, on the host with the port's
planning code), Gaussian sliding window with
mirror TTA on the device, undo resampling and crop on the host, argmax,
NIfTI export.  Host preprocessing runs ahead of the device on worker
threads and export trails behind, as in the JAX package.

``predict_from_folder`` serves through the volume stream by default
(``volume_batch=8``, the JAX package's default): chunks of
``2 * volume_batch`` cases go through ``predict_sliding_window_multi``
with its bfloat16-rounded input, so cases that share a padded shape share
model batches; ``volume_batch=1`` is the per-case path (one case at a
time, f32 input: ``predict_case``'s numbers).  The two differ by the input's bfloat16 rounding, which the
card's bfloat16 model applies anyway.  The ``2d`` configuration serves
through both (2D-over-3D prediction in ``sliding_window.py``).

Spans (``tracing.py``): ``serve.call`` over a call of
``predict_from_folder``; on the worker threads, per case and carrying its
name, ``serve.preprocess`` (children ``serve.read``, ``serve.crop``,
``serve.resample``, ``serve.normalize``) and ``serve.finish`` (children
``serve.restore``, ``serve.argmax``, ``serve.export``); on the calling
thread ``serve.prep_wait``, the wait for a chunk's preprocessing, and
``serve.tail_wait``, the wait for the last exports.  Counter
``serve.cases``: the cases a call serves.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import ndimage

from .. import tracing
from ..planning.fingerprint import crop_to_nonzero
from ..planning.preprocess import normalize, resample_image
from ..utilities.imageio import image_suffix, read_image, write_image
from ..utilities.nifti import NiftiImage
from .sliding_window import predict_sliding_window, predict_sliding_window_multi


def preprocess_for_inference(image_files: list, plans, config_name: str):
    """Load + crop + resample + normalize one case. Returns (data [*sp, C]
    channels-last float32, props dict needed to undo)."""
    with tracing.span("serve.read"):
        imgs = [read_image(f) for f in image_files]
        vols = []
        for img in imgs:
            d = np.asarray(img.data)
            if d.ndim == 4:
                vols.extend(d[..., c].astype(np.float32) for c in range(d.shape[3]))
            else:
                vols.append(d.astype(np.float32))
        data = np.stack(vols, axis=0)
    spacing = imgs[0].spacing
    orig_shape = data.shape[1:]
    # to plans space (coarsest axis first) — undone by restore_softmax
    tf = list(getattr(plans, "transpose_forward", [0, 1, 2]))
    sp_t = [spacing[a] for a in tf]
    with tracing.span("serve.crop"):
        if tf != [0, 1, 2]:
            data = np.ascontiguousarray(data.transpose([0] + [a + 1 for a in tf]))
        data, _, bbox, mask = crop_to_nonzero(data, None)
    cfg = plans.config(config_name)
    target_spacing = np.array(cfg.spacing[-3:], dtype=np.float64)
    with tracing.span("serve.resample"):
        data_r = resample_image(data, sp_t, target_spacing, is_seg=False)
        mask_r = resample_image(mask[None].astype(np.float32), sp_t, target_spacing,
                                is_seg=True)[0] > 0.5
    with tracing.span("serve.normalize"):
        data_n = normalize(data_r, plans, mask_r)
    props = {
        "original_shape": list(orig_shape),   # untransposed
        "original_spacing": list(spacing),    # untransposed
        "transpose_forward": tf,              # bbox/shapes below are in tf space
        "crop_bbox": [[b[0], b[1]] for b in bbox],
        "cropped_shape": list(data.shape[1:]),
        "resampled_shape": list(data_r.shape[1:]),
        "affine": np.asarray(imgs[0].affine),
    }
    return np.moveaxis(data_n, 0, -1), props


def restore_softmax(probs: np.ndarray, props: dict) -> np.ndarray:
    """Resample class probabilities [*sp, K] back to the original cropped
    shape, re-embed into the original volume (undo crop), and un-transpose
    back to the original axis order.  Returns [*orig_shape, K]."""
    cropped = tuple(props["cropped_shape"])
    if probs.shape[:-1] != cropped:
        zoom = np.array(cropped) / np.array(probs.shape[:-1])
        chans = [ndimage.zoom(probs[..., k], zoom, order=1, mode="nearest")
                 for k in range(probs.shape[-1])]
        chans = [c[tuple(slice(0, s) for s in cropped)] for c in chans]
        probs = np.stack(chans, axis=-1)
    tf = list(props.get("transpose_forward", [0, 1, 2]))
    orig_t = [props["original_shape"][a] for a in tf]  # original shape in tf space
    full = np.zeros(tuple(orig_t) + (probs.shape[-1],), np.float32)
    full[..., 0] = 1.0  # outside crop = background
    sl = tuple(slice(b[0], b[1]) for b in props["crop_bbox"])
    full[sl] = probs
    if tf != [0, 1, 2]:
        tb = list(np.argsort(tf))
        full = np.ascontiguousarray(full.transpose(tb + [full.ndim - 1]))
    return full


def remove_all_but_largest_component(seg: np.ndarray, labels=None) -> np.ndarray:
    """Keep only the largest 3D connected component per given label."""
    out = seg.copy()
    labels = labels if labels is not None else [c for c in np.unique(seg) if c > 0]
    for c in labels:
        mask = seg == c
        comp, n = ndimage.label(mask)
        if n <= 1:
            continue
        sizes = ndimage.sum(mask, comp, range(1, n + 1))
        keep = int(np.argmax(sizes)) + 1
        out[mask & (comp != keep)] = 0
    return out


def finalize_case(probs: np.ndarray, props: dict, postprocess_labels=None):
    """Fold-ensembled softmax [*resampled, K] -> (seg, full softmax, props):
    undo resampling/crop/transpose, argmax, optional CC postprocessing."""
    with tracing.span("serve.restore"):
        full = restore_softmax(probs, props)
    with tracing.span("serve.argmax"):
        seg = np.argmax(full, axis=-1).astype(np.uint8)
    if postprocess_labels is not None:
        seg = remove_all_but_largest_component(seg, postprocess_labels)
    return seg, full, props


def export_segmentation(seg: np.ndarray, props: dict, out_file: str):
    write_image(out_file, NiftiImage(seg.astype(np.uint8),
                                     spacing=tuple(props["original_spacing"]),
                                     affine=np.asarray(props["affine"])))


def predict_case(models_per_fold: list, image_files: list, plans,
                 config_name: str, *, device: torch.device, mirror_axes=(0, 1, 2),
                 step_fraction=0.5, window_batch: int = 4, do_tta: bool = True,
                 postprocess_labels=None, preprocessed=None):
    """Predict one case, ensembling softmax over folds (one model per fold,
    on ``device``).  Returns (seg uint8 [*orig_shape], softmax [*orig, K],
    props).  ``preprocessed`` optionally supplies ``(data, props)``."""
    data, props = preprocessed or preprocess_for_inference(
        image_files, plans, config_name)
    cfg = plans.config(config_name)
    probs = None
    for model in models_per_fold:
        # bf16-rounded probabilities, as the JAX package's device->host
        # transfer; ensembling, resampling and argmax run in f32 on the host.
        # A ViT-U-Net's position embeddings fix its window: the patch it was
        # trained at (restore_model sets it from the manifest), which may
        # differ from the plans' (the JAX package windows with the plans')
        p = predict_sliding_window(
            model, data, getattr(model, "patch_size", cfg.patch_size),
            plans.num_classes + 1, device=device,
            mirror_axes=mirror_axes if do_tta else (),
            step_fraction=step_fraction, window_batch=window_batch,
            output="probs_bf16")
        probs = p if probs is None else probs + p
    probs = probs / len(models_per_fold)
    return finalize_case(probs, props, postprocess_labels)


def case_files(input_folder: str) -> list:
    """[(case, sorted image files)] of a folder of ``<case>_0000.nii.gz``
    images, ordered by case."""
    cases: dict = {}
    for f in sorted(os.listdir(input_folder)):
        suffix = image_suffix(f)
        if not suffix:
            continue
        base = f[: -len(suffix)]
        case = base[:-5] if len(base) > 5 and base[-5] == "_" and base[-4:].isdigit() else base
        cases.setdefault(case, []).append(os.path.join(input_folder, f))
    return [(c, sorted(fs)) for c, fs in sorted(cases.items())]


def _preprocess(case: str, image_files: list, plans, config_name: str):
    with tracing.span("serve.preprocess", case=case):
        return preprocess_for_inference(image_files, plans, config_name)


def _finish_case(case: str, probs: np.ndarray, props: dict, postprocess_labels,
                 out_file: str):
    """The host tail of one case: undo, argmax, export."""
    with tracing.span("serve.finish", case=case):
        seg, _, props = finalize_case(probs, props, postprocess_labels)
        with tracing.span("serve.export"):
            export_segmentation(seg, props, out_file)


def predict_from_folder(models_per_fold: list, plans, config_name: str,
                        input_folder: str, output_folder: str, *,
                        device: torch.device, do_tta: bool = True,
                        window_batch: int = 4, postprocess_labels=None,
                        io_workers: int = 2, lookahead: int = 2,
                        volume_batch: int = 8) -> list:
    """Predict every case in ``input_folder`` into
    ``output_folder/<case>.nii.gz``; returns the written paths in case
    order.  Preprocessing runs ``lookahead`` cases ahead of the device on
    worker threads; the host tail (undo, argmax, export) trails behind.
    ``volume_batch > 1`` serves chunks of ``max(2 * volume_batch, 2)``
    cases through the volume stream with its bfloat16-rounded input (the
    JAX package's chunked loop, softmax summed over folds);
    ``volume_batch=1`` serves case by case from the f32 input, as
    ``predict_case`` does."""
    with tracing.span("serve.call"):
        os.makedirs(output_folder, exist_ok=True)
        ordered = case_files(input_folder)
        tracing.count("serve.cases", len(ordered))
        written = []
        with ThreadPoolExecutor(max_workers=io_workers) as pool:
            prep = {}

            def submit_prep(idx):
                if 0 <= idx < len(ordered) and idx not in prep:
                    prep[idx] = pool.submit(_preprocess, *ordered[idx], plans, config_name)

            def case_out(case):
                out_file = os.path.join(output_folder, f"{case}.nii.gz")
                written.append(out_file)
                return out_file

            for i in range(lookahead + 1):
                submit_prep(i)
            exports = []
            cfg = plans.config(config_name)
            chunk_n = max(2 * volume_batch, 2) if volume_batch > 1 else 1
            for i in range(0, len(ordered), chunk_n):
                chunk = ordered[i:i + chunk_n]
                pres = []
                with tracing.span("serve.prep_wait"):
                    for j in range(len(chunk)):
                        pres.append(prep.pop(i + j).result())
                        submit_prep(i + j + lookahead + 1)
                probs = None
                for model in models_per_fold:
                    ps = predict_sliding_window_multi(
                        model, [p[0] for p in pres],
                        getattr(model, "patch_size", cfg.patch_size), plans.num_classes + 1,
                        device=device, mirror_axes=(0, 1, 2) if do_tta else (),
                        window_batch=window_batch, output="probs_bf16",
                        input_bf16=volume_batch > 1, volume_batch=volume_batch)
                    probs = ps if probs is None else [a + b for a, b in zip(probs, ps)]
                for (case, _), p, (_, props) in zip(chunk, probs, pres):
                    exports.append(pool.submit(_finish_case, case, p / len(models_per_fold),
                                               props, postprocess_labels, case_out(case)))
            with tracing.span("serve.tail_wait"):
                for f in exports:
                    f.result()
        return written
