"""Preprocessed-dataset access + deterministic splits: the port of
``lifelong_nnunet_tpu/data/dataset.py``, without scikit-learn.

Replaces upstream nnU-Net's ``load_dataset``/``unpack_dataset`` and the
reference's split logic.  Determinism anchors preserved exactly
(SURVEY.md §6): 5-fold KFold with seed 12345 and shuffle
(reference ``multihead/nnUNetTrainerMultiHead.py:214``), and the
parameter-search 80:20 re-split of the train portion with seed 3299
(``:237``).
"""

from __future__ import annotations

import json
import os

import numpy as np


class PreprocessedDataset:
    """Read access to one preprocessed stage directory ( ``<case>.npy`` files
    written by planning.preprocess).  Arrays are memmapped so patch extraction
    touches only the voxels it needs."""

    def __init__(self, stage_dir: str):
        self.stage_dir = stage_dir
        self.cases = sorted(
            f[:-4] for f in os.listdir(stage_dir)
            if f.endswith(".npy") and not f.endswith(".classlocs.npy")
        )
        self._classlocs: dict = {}

    def load(self, case: str) -> np.ndarray:
        return np.load(os.path.join(self.stage_dir, f"{case}.npy"), mmap_mode="r")

    def props(self, case: str) -> dict:
        with open(os.path.join(self.stage_dir, f"{case}.props.json")) as f:
            return json.load(f)

    def class_locations(self, case: str) -> dict:
        if case not in self._classlocs:
            p = os.path.join(self.stage_dir, f"{case}.classlocs.npz")
            with np.load(p) as z:
                self._classlocs[case] = {int(k): z[k] for k in z.files}
        return self._classlocs[case]


def kfold_split(cases: list[str], fold: int, n_splits: int = 5, seed: int = 12345):
    """The reference's 5-fold split over the sorted case list, as
    ``sklearn.model_selection.KFold(shuffle=True, random_state=seed)`` makes
    it: the indices shuffled by ``np.random.RandomState(seed)``, cut into
    ``n_splits`` folds of which the first ``n % n_splits`` are one larger;
    train and val each in ascending index order.  Fold -1 / 'all' trains on
    everything."""
    cases = sorted(cases)
    if fold == -1 or fold == "all":
        return list(cases), list(cases)
    if len(cases) < 2:
        return list(cases), list(cases)
    n = len(cases)
    n_splits = min(n_splits, n)
    fold = fold % n_splits
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[: n % n_splits] += 1
    start = int(sizes[:fold].sum())
    val = np.zeros(n, dtype=bool)
    val[order[start:start + sizes[fold]]] = True
    return [cases[i] for i in np.flatnonzero(~val)], [cases[i] for i in np.flatnonzero(val)]


def final_splits(task_dir: str, cases, n_splits: int = 5, seed: int = 12345) -> list:
    """``splits_final.json`` in the preprocessed task dir (upstream nnU-Net's
    user-editable ``splits_final.pkl``): read when present — users pin custom
    splits by editing it — else compute every fold with ``kfold_split`` and
    write it.  Returns ``[{"train": [...], "val": [...]}, ...]``."""
    path = os.path.join(task_dir, "splits_final.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    n = min(n_splits, len(cases)) if len(cases) >= 2 else 1
    splits = []
    for fold in range(n):
        tr, val = kfold_split(cases, fold, n_splits=n_splits, seed=seed)
        splits.append({"train": tr, "val": val})
    try:
        with open(path, "w") as f:
            json.dump(splits, f, indent=2)
    except OSError:
        pass  # read-only preprocessed tree: in-memory splits still apply
    return splits


def param_search_split(train_cases: list[str], seed: int = 3299, val_frac: float = 0.2):
    """80:20 re-split of the *train* portion for parameter search so real
    validation data never leaks (reference ``multihead/…:193-243``)."""
    rng = np.random.RandomState(seed)
    cases = list(train_cases)
    perm = rng.permutation(len(cases))
    n_val = max(1, int(round(val_frac * len(cases))))
    val = sorted(cases[i] for i in perm[:n_val])
    tr = sorted(cases[i] for i in perm[n_val:])
    return tr, val
