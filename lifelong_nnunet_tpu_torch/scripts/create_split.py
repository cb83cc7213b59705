"""Carve a held-out test split out of a raw task (the port's copy of
``lifelong_nnunet_tpu/scripts/create_split.py``, reference
``nnunet_ext/scripts/create_3_split.py``): moves a deterministic fraction of
(image, label) pairs from imagesTr/labelsTr into imagesTs/labelsTs."""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from .. import paths


def create_split(task_dir: str, test_fraction: float = 0.25, seed: int = 3299) -> list:
    from ..planning.fingerprint import list_cases
    cases = list_cases(task_dir)
    rng = np.random.RandomState(seed)
    n_test = max(1, int(round(test_fraction * len(cases))))
    test_cases = sorted(np.array(cases)[rng.permutation(len(cases))[:n_test]])
    os.makedirs(os.path.join(task_dir, "imagesTs"), exist_ok=True)
    os.makedirs(os.path.join(task_dir, "labelsTs"), exist_ok=True)
    moved = []
    for case in test_cases:
        for f in os.listdir(os.path.join(task_dir, "imagesTr")):
            if f.startswith(case):
                shutil.move(os.path.join(task_dir, "imagesTr", f),
                            os.path.join(task_dir, "imagesTs", f))
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(task_dir, "labelsTr", case + ext)
            if os.path.isfile(p):
                shutil.move(p, os.path.join(task_dir, "labelsTs", case + ext))
        moved.append(case)
    return moved


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("-fraction", type=float, default=0.25)
    p.add_argument("-seed", type=int, default=3299)
    args = p.parse_args(argv)
    raw = paths.require(paths.raw_data_dir(create=False), "raw data")
    from ..run.plan_and_preprocess import resolve_task
    for t in args.task_ids:
        td = resolve_task(t, raw)
        moved = create_split(td, args.fraction, args.seed)
        print(f"{os.path.basename(td)}: moved {len(moved)} cases to test split")


if __name__ == "__main__":
    main()
