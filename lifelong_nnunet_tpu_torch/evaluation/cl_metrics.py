"""Continual-learning metrics of a trained task sequence: the accuracy
matrix, BWT and FWT, the port of
``lifelong_nnunet_tpu/evaluation/cl_metrics.py``.

Each stage checkpoint (the model after stage t of the sequence) is
evaluated on every task's validation split by :class:`~.evaluator.Evaluator`;
``A[t, i]`` is the mean over subjects of the subject's mean foreground Dice
on task i after stage t, and BWT / FWT follow Lopez-Paz & Ranzato (GEM)
(``metrics.py``).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from .metrics import backward_transfer, forward_transfer


def mean_dice_of(results: dict, task: str) -> float:
    """Mean over ``task``'s subjects of each subject's mean Dice over the
    foreground classes (NaN classes left out), from ``evaluate_on``'s
    results."""
    vals = [np.nanmean(m["Dice"]) for m in results[task]["subjects"].values()]
    return float(np.nanmean(vals)) if vals else float("nan")


def accuracy_matrix(per_stage_checkpoints: list, task_stage_dirs: dict,
                    options=None) -> np.ndarray:
    """``per_stage_checkpoints``: the checkpoint base path (no extension) of
    the model after each stage, in order; ``task_stage_dirs``: {task:
    preprocessed stage dir}; ``options``: the ``TrainerOptions`` to restore
    with (its device).  Returns ``A[t, i]``."""
    from .evaluator import Evaluator
    tasks = list(task_stage_dirs)
    acc = np.full((len(per_stage_checkpoints), len(tasks)), np.nan)
    for t, ckpt in enumerate(per_stage_checkpoints):
        ev = Evaluator(ckpt, options)
        with tempfile.TemporaryDirectory() as tmp:
            res = ev.evaluate_on(task_stage_dirs, tmp)
        for i, task in enumerate(tasks):
            if task in res:
                acc[t, i] = mean_dice_of(res, task)
    return acc


def cl_report(acc: np.ndarray, tasks: list, baseline: np.ndarray | None = None) -> dict:
    """The matrix with its final mean Dice, BWT and FWT (against
    ``baseline`` per task, 0 if not given)."""
    return {
        "tasks": list(tasks),
        "accuracy_matrix": acc.tolist(),
        "final_mean_dice": float(np.nanmean(acc[-1])),
        "BWT": backward_transfer(acc),
        "FWT": forward_transfer(acc, baseline),
    }


def write_cl_report(report: dict, output_folder: str) -> None:
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, "cl_metrics.json"), "w") as f:
        json.dump(report, f, indent=2)
