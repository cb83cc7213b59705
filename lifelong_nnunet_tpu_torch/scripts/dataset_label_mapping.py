"""CLI: Decathlon-style dataset conversion —
``nnUNet_torch_dataset_label_mapping``, the port's copy of
``lifelong_nnunet_tpu/scripts/dataset_label_mapping.py``.

Counterpart of ``nnunet_ext/experiment_planning/dataset_label_mapping.py``:
  * channel selection from 4D NIfTIs (``:19-80``)
  * mask relabeling via a ``{"old_name --> old_label": new_label}`` JSON
    mapping, or label joining (``:82-114``)
  * split of 4D images into per-modality files (upstream ``split_4d``)
  * ends by running the port's plan-and-preprocess (the reference shells out to
    ``nnUNet_plan_and_preprocess``, ``:225``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from .. import paths
from ..utilities.imageio import image_suffix, read_image, write_image
from ..utilities.nifti import NiftiImage


def select_channel(img_4d: np.ndarray, channel: int) -> np.ndarray:
    assert img_4d.ndim == 4, "channel selection requires a 4D image"
    return np.ascontiguousarray(img_4d[..., channel])


def apply_label_mapping(seg: np.ndarray, mapping: dict) -> np.ndarray:
    """mapping: {old_label(int): new_label(int)}. Unmapped labels -> 0."""
    out = np.zeros_like(seg)
    for old, new in mapping.items():
        out[seg == int(old)] = int(new)
    return out


def parse_mapping_file(path: str) -> dict:
    """Reference JSON format: {"<structure name> --> <old_label>": new_label}."""
    with open(path) as f:
        raw = json.load(f)
    mapping = {}
    for k, v in raw.items():
        old = int(k.split("-->")[-1].strip()) if "-->" in k else int(k)
        mapping[old] = int(v)
    return mapping


def split_4d(task_dir: str, out_dir: str):
    """Split 4D imagesTr/Ts into per-modality _0000 style files (upstream
    ``nnUNet_convert_decathlon_task`` behavior)."""
    for sub in ("imagesTr", "imagesTs"):
        src = os.path.join(task_dir, sub)
        dst = os.path.join(out_dir, sub)
        if not os.path.isdir(src):
            continue
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            if not image_suffix(f) or f.startswith("."):
                continue
            base = f[: -len(image_suffix(f))]
            img = read_image(os.path.join(src, f))
            data = np.asarray(img.data)
            if data.ndim == 4:
                for c in range(data.shape[3]):
                    write_image(os.path.join(dst, f"{base}_{c:04d}.nii.gz"),
                                NiftiImage(np.ascontiguousarray(data[..., c]),
                                           img.spacing, img.affine))
            else:
                write_image(os.path.join(dst, f"{base}_0000.nii.gz"), img)
    lsrc = os.path.join(task_dir, "labelsTr")
    ldst = os.path.join(out_dir, "labelsTr")
    if os.path.isdir(lsrc):
        os.makedirs(ldst, exist_ok=True)
        for f in os.listdir(lsrc):
            if image_suffix(f):
                shutil.copy(os.path.join(lsrc, f), os.path.join(ldst, f))
    dj = os.path.join(task_dir, "dataset.json")
    if os.path.isfile(dj):
        shutil.copy(dj, os.path.join(out_dir, "dataset.json"))


def convert_task(src_task_dir: str, dst_task_dir: str, mapping: dict | None = None,
                 channel: int | None = None, joined_labels: list | None = None,
                 new_labels_json: dict | None = None):
    """Full conversion: split 4d / channel-select, relabel masks, write
    dataset.json, ready for planning."""
    split_4d(src_task_dir, dst_task_dir)
    if channel is not None:
        img_dir = os.path.join(dst_task_dir, "imagesTr")
        keep = f"_{channel:04d}"
        for f in list(os.listdir(img_dir)):
            if f.endswith(".nii.gz") and not f[:-7].endswith(keep):
                os.remove(os.path.join(img_dir, f))
    lab_dir = os.path.join(dst_task_dir, "labelsTr")
    if mapping or joined_labels:
        for f in os.listdir(lab_dir):
            if not image_suffix(f):
                continue
            p = os.path.join(lab_dir, f)
            img = read_image(p)
            seg = np.asarray(img.data).astype(np.int16)
            if joined_labels:
                new = np.zeros_like(seg)
                for lab in joined_labels:
                    new[seg == int(lab)] = 1
                seg = new
            else:
                seg = apply_label_mapping(seg, mapping)
            write_image(p, NiftiImage(seg.astype(np.uint8), img.spacing, img.affine))
    dj_path = os.path.join(dst_task_dir, "dataset.json")
    if os.path.isfile(dj_path):
        with open(dj_path) as f:
            dj = json.load(f)
        if new_labels_json:
            dj["labels"] = new_labels_json
        elif joined_labels:
            dj["labels"] = {"0": "background", "1": "joined"}
        if channel is not None and "modality" in dj:
            dj["modality"] = {"0": dj["modality"].get(str(channel), "unknown")}
        with open(dj_path, "w") as f:
            json.dump(dj, f, indent=2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("-new_tasks", nargs="+", required=True,
                   help="new task names (one per input task)")
    p.add_argument("-mapping_file", default=None,
                   help='json {"name --> old_label": new_label}')
    p.add_argument("-channel", type=int, default=None)
    p.add_argument("-join_labels", nargs="+", type=int, default=None)
    p.add_argument("--no_plan", action="store_true")
    args = p.parse_args(argv)
    raw = paths.require(paths.raw_data_dir(), "raw data")
    from ..run.plan_and_preprocess import plan_and_preprocess, resolve_task
    mapping = parse_mapping_file(args.mapping_file) if args.mapping_file else None
    new_dirs = []
    for t, new in zip(args.task_ids, args.new_tasks):
        src = resolve_task(t, raw)
        dst = os.path.join(raw, new)
        convert_task(src, dst, mapping=mapping, channel=args.channel,
                     joined_labels=args.join_labels)
        new_dirs.append(dst)
        print(f"converted {src} -> {dst}")
    if not args.no_plan:
        pre = paths.require(paths.preprocessed_dir(), "preprocessed data")
        plan_and_preprocess(new_dirs, pre)


if __name__ == "__main__":
    main()
