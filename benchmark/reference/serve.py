"""The plain reference of serving one CT volume: nnU-Net's CT
normalization, the Gaussian-weighted sliding window with mirroring over
every subset of the spatial axes, and the class probabilities, in float32
with TF32 off.

The window grid is the one the system defines for an even patch at step
0.5: the volume is padded (zeros) to at least the patch, centred, then on
the high side up to ``patch + (patch / 2) * ceil((size - patch) /
(patch / 2))``; windows start at every multiple of ``patch / 2`` that
fits.  Each window's softmax, averaged over the mirrors, is weighted by a
Gaussian of sd ``patch / 8`` centred at ``patch // 2`` (peak 1) and summed;
the sum is divided by the summed weights.

A box of the volume needs only the windows that overlap it: every window
that covers one of its voxels is run, so its probabilities are exact.  A
box that is one cell of the grid (``patch / 2`` a side, at a multiple of
it) takes at most two windows an axis.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import model


def gaussian(patch, device) -> torch.Tensor:
    g = None
    for p in patch:
        t = torch.arange(p, dtype=torch.float64, device=device)
        a = torch.exp(-0.5 * ((t - p // 2) / (p / 8.0)) ** 2)
        g = a if g is None else g[..., None] * a
    return (g / g.max()).float()


def grid(spatial, patch):
    """(pads [(lo, hi)], window origins per axis) of the window grid."""
    pads, origins = [], []
    for s, p in zip(spatial, patch):
        need = max(0, p - s)
        lo, padded = need // 2, max(s, p)
        step = p // 2
        bucket = p + step * math.ceil(max(0, padded - p) / step)
        pads.append((lo, need - lo + bucket - padded))
        origins.append(range(0, bucket - p + 1, step))
    return pads, origins


def grid_cells(spatial, patch, voxels: int, rng: np.random.Generator) -> list:
    """Boxes ``[(start, stop)]`` per axis, in image coordinates: distinct
    cells of the window grid (``patch / 2`` a side at its multiples, clipped
    to the image), in an order drawn with ``rng``, until they hold
    ``voxels`` voxels or the whole image."""
    pads, origins = grid(spatial, patch)
    axes = []
    for (lo, _), o, s, p in zip(pads, origins, spatial, patch):
        step = p // 2
        cells = [(max(0, m * step - lo), min(s, (m + 1) * step - lo)) for m in range(len(o) + 1)]
        axes.append([c for c in cells if c[1] > c[0]])
    out, held = [], 0
    for k in rng.permutation(math.prod(len(a) for a in axes)):
        if held >= voxels:
            break
        box = []
        for a in reversed(axes):
            box.append(a[k % len(a)])
            k //= len(a)
        out.append(tuple(reversed(box)))
        held += math.prod(b - a for a, b in out[-1])
    return out


def probabilities(params: dict, layers, image: torch.Tensor, patch, box,
                  quant: bool = False) -> torch.Tensor:
    """``image [C, *spatial]`` (normalized) -> class probabilities
    ``[K, *box]`` float32 over ``box`` (``[(start, stop)]`` per axis, image
    coordinates); one window (its mirrors as one batch) at a time."""
    spatial = image.shape[1:]
    dim = len(patch)
    pads, origins = grid(spatial, patch)
    flat = [x for lo_hi in reversed(pads) for x in lo_hi]
    x = torch.nn.functional.pad(image, flat)
    # the box in padded coordinates, and the windows that overlap it
    pbox = [(a + lo, b + lo) for (a, b), (lo, _) in zip(box, pads)]
    hit = [[o for o in axis if o < b and o + p > a]
           for axis, (a, b), p in zip(origins, pbox, patch)]
    g = gaussian(patch, image.device)
    K = layers[-1].cout
    size = tuple(b - a for a, b in pbox)
    acc = torch.zeros((K,) + size, device=image.device)
    weight = torch.zeros(size, device=image.device)
    combos = [c for r in range(dim + 1) for c in itertools.combinations(range(dim), r)]
    with torch.no_grad():
        for o in itertools.product(*hit):
            win = (slice(None),) + tuple(slice(a, a + p) for a, p in zip(o, patch))
            w = x[win]
            batch = torch.stack([w.flip([a + 1 for a in c]) if c else w for c in combos])
            logits = model.forward(params, batch, layers, quant)[0]
            probs = sum(torch.softmax(logits[i], 0).flip([a + 1 for a in c]) if c
                        else torch.softmax(logits[i], 0) for i, c in enumerate(combos))
            # the part of the window inside the box, in window and box coordinates
            lo = [max(a, oa) for (a, _), oa in zip(pbox, o)]
            hi = [min(b, oa + p) for (_, b), oa, p in zip(pbox, o, patch)]
            in_win = tuple(slice(l - oa, h - oa) for l, h, oa in zip(lo, hi, o))
            in_box = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, pbox))
            acc[(slice(None),) + in_box] += (probs / len(combos) * g)[(slice(None),) + in_win]
            weight[in_box] += g[in_win]
    return acc / weight


def served_gap(probs: torch.Tensor, served: np.ndarray) -> float:
    """The widest gap by which the served label's reference probability
    lies below the reference's best, over every voxel of ``probs``."""
    lab = torch.from_numpy(served.astype(np.int64)).to(probs.device)
    picked = torch.gather(probs, 0, lab[None])[0]
    return float((probs.amax(0) - picked).amax())


def calibrate_background(params: dict, layers, volume: torch.Tensor, share: float) -> None:
    """Raise the served head's background bias so that ``share`` of the
    voxels of the window at the centre of ``volume [1, C, *spatial]`` are
    labelled foreground: random weights label every class alike, in noise
    at the scale of a voxel; a served CT volume is mostly background."""
    head = layers[-1]
    patch = head.out_spatial
    lo = [max(0, (s - p) // 2) for s, p in zip(volume.shape[2:], patch)]
    win = volume[(slice(None), slice(None)) + tuple(slice(a, a + p) for a, p in zip(lo, patch))]
    with torch.no_grad():
        logits = model.forward(params, win, layers)[0][0].flatten(1)
    margin = logits[1:].amax(0) - logits[0]
    k = max(1, int(round((1.0 - share) * margin.numel())))
    params[f"{head.name}.bias"][0] += margin.kthvalue(k).values
