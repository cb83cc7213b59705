"""CLI: merge several raw tasks into one new task —
``nnUNet_torch_join_datasets``, the port's copy of
``lifelong_nnunet_tpu/scripts/join_datasets.py`` (reference
``nnunet_ext/scripts/join_datasets.py``)."""

from __future__ import annotations

import argparse
import json
import os
import shutil

from .. import paths


def join_tasks(task_dirs: list, out_dir: str):
    os.makedirs(os.path.join(out_dir, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labelsTr"), exist_ok=True)
    labels, modality = None, None
    n = 0
    for td in task_dirs:
        prefix = os.path.basename(td.rstrip("/"))
        with open(os.path.join(td, "dataset.json")) as f:
            dj = json.load(f)
        if labels is None:
            labels, modality = dj["labels"], dj["modality"]
        elif dj["labels"] != labels:
            raise ValueError(f"{td}: label map differs — cannot join")
        for sub in ("imagesTr", "labelsTr"):
            src = os.path.join(td, sub)
            for f in sorted(os.listdir(src)):
                if f.endswith((".nii", ".nii.gz")):
                    shutil.copy(os.path.join(src, f),
                                os.path.join(out_dir, sub, f"{prefix}_{f}"))
                    n += 1
    with open(os.path.join(out_dir, "dataset.json"), "w") as f:
        json.dump({"name": os.path.basename(out_dir), "labels": labels,
                   "modality": modality}, f, indent=2)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("-task_name", required=True, help="name of the joined task")
    args = p.parse_args(argv)
    raw = paths.require(paths.raw_data_dir(), "raw data")
    from ..run.plan_and_preprocess import resolve_task
    dirs = [resolve_task(t, raw) for t in args.task_ids]
    out = os.path.join(raw, args.task_name)
    n = join_tasks(dirs, out)
    print(f"joined {len(dirs)} tasks into {out} ({n} files)")


if __name__ == "__main__":
    main()
