"""Segmentation + continual-learning metrics.

Per-subject Dice/IoU from hard tp/fp/fn (reference
``multihead/nnUNetTrainerMultiHead.py:963-1049``,
``evaluator2.py:60-109``) and first-class BWT/FWT (the reference only
advertises these, computing them in an offline notebook — SURVEY.md §5
says the rebuild should make them library outputs).
"""

from __future__ import annotations

import numpy as np


def dice_from_counts(tp, fp, fn, smooth: float = 0.0):
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, (2 * tp + smooth) / (denom + smooth), np.nan)


def iou_from_counts(tp, fp, fn, smooth: float = 0.0):
    denom = tp + fp + fn
    return np.where(denom > 0, (tp + smooth) / (denom + smooth), np.nan)


def confusion_counts(pred: np.ndarray, target: np.ndarray, num_classes: int):
    """Hard per-class tp/fp/fn over one subject (background excluded)."""
    valid = target >= 0
    tps, fps, fns = [], [], []
    for c in range(1, num_classes):
        p = (pred == c) & valid
        y = (target == c) & valid
        tps.append(int(np.sum(p & y)))
        fps.append(int(np.sum(p & ~y)))
        fns.append(int(np.sum(~p & y)))
    return np.array(tps), np.array(fps), np.array(fns)


def subject_metrics(pred: np.ndarray, target: np.ndarray, num_classes: int) -> dict:
    tp, fp, fn = confusion_counts(pred, target, num_classes)
    return {
        "Dice": dice_from_counts(tp, fp, fn).tolist(),
        "IoU": iou_from_counts(tp, fp, fn).tolist(),
    }


def backward_transfer(acc_matrix: np.ndarray) -> float:
    """BWT = mean over tasks i<T of acc[T-1, i] - acc[i, i].
    acc_matrix[t, i] = metric on task i after training task t."""
    T = acc_matrix.shape[0]
    if T < 2:
        return 0.0
    vals = [acc_matrix[T - 1, i] - acc_matrix[i, i] for i in range(T - 1)]
    return float(np.nanmean(vals))


def forward_transfer(acc_matrix: np.ndarray, baseline: np.ndarray | None = None) -> float:
    """FWT = mean over tasks i>0 of acc[i-1, i] - baseline[i] (baseline:
    metric of an untrained/reference model on task i; 0 if not given)."""
    T = acc_matrix.shape[0]
    if T < 2:
        return 0.0
    base = baseline if baseline is not None else np.zeros(T)
    vals = [acc_matrix[i - 1, i] - base[i] for i in range(1, T)]
    return float(np.nanmean(vals))
