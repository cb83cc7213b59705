"""Segmentation losses: soft Dice + cross-entropy with deep supervision, the
port of ``lifelong_nnunet_tpu/ops/losses.py``.

Logits are channels-first ``[B, C, *spatial]`` (the U-Net's layout), float32;
``target`` is integer class labels ``[B, *spatial]``, ``-1`` marks ignore
(outside the nonzero mask / padding).  Deep-supervision weights are
``1/2^i`` with the coarsest output zeroed, normalized to sum 1.

Under data parallelism every reduction over the batch takes ``dp``, the
rank's :class:`~..parallel.collectives.DataGroup`: its partial sums are
summed over the data group (an all-reduce with an identity backward), so
each rank holds the global-batch loss and the gradient of its own rows'
share of it.  ``dp=None`` (one rank) computes the same expressions
locally.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gsum(x: torch.Tensor, dp=None) -> torch.Tensor:
    """``x`` summed over the data group (``x`` itself without one)."""
    return x if dp is None else dp.sum(x)


def gmean(x: torch.Tensor, dp=None) -> torch.Tensor:
    """The mean of ``x`` over every rank's elements."""
    if dp is None:
        return x.mean()
    return dp.sum(x.sum()) / dp.sum(torch.tensor(float(x.numel()), device=x.device))


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[B, *sp] labels -> [B, C, *sp] float32; ignore (-1) maps to class 0."""
    t = target.clamp(0, num_classes - 1).long()
    return F.one_hot(t, num_classes).movedim(-1, 1).float()


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, batch_dice: bool = True,
                   smooth: float = 1e-5, ignore_background: bool = True,
                   dp=None) -> torch.Tensor:
    """1 - soft Dice over foreground classes.  ``batch_dice=True`` pools
    tp/fp/fn over the whole batch, else per sample then averaged."""
    num_classes = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    valid = (target >= 0).unsqueeze(1).float()
    y = one_hot(target, num_classes) * valid
    p = probs * valid
    spatial = tuple(range(2, logits.dim()))
    axes = (0,) + spatial if batch_dice else spatial
    tp = (p * y).sum(dim=axes)
    fp = (p * (1.0 - y)).sum(dim=axes)
    fn = ((1.0 - p) * y).sum(dim=axes)
    if batch_dice and dp is not None:
        tp, fp, fn = dp.sum(torch.stack([tp, fp, fn])).unbind(0)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    if ignore_background:
        dc = dc[..., 1:]
    return 1.0 - gmean(dc, None if batch_dice else dp)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       ignore_index: int = -1, dp=None) -> torch.Tensor:
    """Mean CE over voxels with target != ignore_index."""
    valid = (target != ignore_index).float()
    logp = torch.log_softmax(logits, dim=1)
    ce = -(one_hot(target, logits.shape[1]) * logp).sum(dim=1)
    return gsum((ce * valid).sum(), dp) / gsum(valid.sum(), dp).clamp(min=1.0)


def dc_and_ce_loss(logits, target, batch_dice: bool = True, smooth: float = 1e-5, dp=None):
    return soft_dice_loss(logits, target, batch_dice, smooth, dp=dp) \
        + cross_entropy_loss(logits, target, dp=dp)


def ds_weights(num_outputs: int) -> np.ndarray:
    """Deep-supervision weights: 1/2^i, the COARSEST output zeroed,
    normalized to sum 1."""
    w = np.array([1.0 / (2 ** i) for i in range(num_outputs)])
    if num_outputs >= 2:
        w[-1] = 0.0
    return (w / w.sum()).astype(np.float32)


def downsample_target(target: torch.Tensor, factor) -> torch.Tensor:
    """Nearest-neighbor downsample of integer targets by per-axis factor."""
    if all(f == 1 for f in factor):
        return target
    return target[(slice(None),) + tuple(slice(None, None, int(f)) for f in factor)]


def deep_supervision_loss(outputs: list, target: torch.Tensor, ds_factors,
                          batch_dice: bool = True, dp=None) -> torch.Tensor:
    """Weighted DC+CE over the deep-supervision outputs, highest resolution
    first; ``target [B, *spatial]``."""
    w = ds_weights(len(outputs))
    total = 0.0
    for i, (out, f) in enumerate(zip(outputs, ds_factors)):
        if w[i] == 0.0:
            continue
        total = total + float(w[i]) * dc_and_ce_loss(out, downsample_target(target, f),
                                                     batch_dice, dp=dp)
    return total


def online_eval_counts(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                       dp=None):
    """Hard tp/fp/fn per foreground class from the full-resolution output:
    three int64 tensors [num_classes - 1], summed over the data group."""
    pred = logits.argmax(dim=1)
    valid = target >= 0
    tps, fps, fns = [], [], []
    for c in range(1, num_classes):
        p = (pred == c) & valid
        y = (target == c) & valid
        tps.append((p & y).sum())
        fps.append((p & ~y).sum())
        fns.append((~p & y).sum())
    counts = torch.stack([torch.stack(tps), torch.stack(fps), torch.stack(fns)])
    if dp is not None:
        dp.sum_(counts)
    return counts.unbind(0)
