"""The plain reference of nnU-Net's train step: the deep-supervision Dice +
cross-entropy loss and the optimizer (clip at global norm 12, weight decay
3e-5, Nesterov SGD with momentum 0.99 at the poly learning rate), run on
the batches of ``inputs.Sampler`` augmented by ``inputs.augment``, in
float32 with TF32 off."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import inputs, model

CLIP, WEIGHT_DECAY, MOMENTUM, LR0 = 12.0, 3e-5, 0.99, 1e-2


def ds_weights(n: int) -> list:
    w = [1.0 / 2 ** i for i in range(n)]
    if n >= 2:
        w[-1] = 0.0
    s = sum(w)
    return [x / s for x in w]


def dc_ce(logits, target, smooth: float = 1e-5):
    """Batch soft Dice over the foreground classes plus the mean
    cross-entropy over the voxels whose label is not -1."""
    K = logits.shape[1]
    valid = (target >= 0)
    y = F.one_hot(target.clamp(0, K - 1).long(), K).movedim(-1, 1).float() \
        * valid[:, None].float()
    probs = torch.softmax(logits, 1) * valid[:, None].float()
    axes = (0,) + tuple(range(2, logits.dim()))
    tp = (probs * y).sum(axes)
    fp = (probs * (1 - y)).sum(axes)
    fn = ((1 - probs) * y).sum(axes)
    dice = ((2 * tp + smooth) / (2 * tp + fp + fn + smooth))[1:]
    ce = -(torch.log_softmax(logits, 1) * y).sum(1)
    return (1 - dice.mean()) + (ce * valid).sum() / valid.sum().clamp(min=1)


def ds_loss(outputs, target, factors):
    total = 0.0
    for out, f, w in zip(outputs, factors, ds_weights(len(outputs))):
        if w:
            t = target[(slice(None),) + tuple(slice(None, None, int(s)) for s in f)]
            total = total + w * dc_ce(out, t)
    return total


def poly_lr(step: int, iters_per_epoch: int, max_epochs: int = 1000) -> float:
    return LR0 * (1 - (step // iters_per_epoch) / max_epochs) ** 0.9


def run_steps(params0: dict, batches, layers, factors, gen: torch.Generator,
              iters_per_epoch: int, quant: bool = False, rows=None) -> dict:
    """Train a copy of ``params0`` over ``batches`` ([(data, seg)] numpy, the
    sampler's), augmenting each with ``gen``.  Returns the loss of each
    step, the first step's momentum buffer (the clipped gradient plus the
    decay) and each parameter's change after the last step, by name.
    ``rows``: the rows of each batch that the loss sees (a fault's
    reading)."""
    names = list(params0)
    params = {n: params0[n].detach().clone().requires_grad_(True) for n in names}
    buf, losses, first = {}, [], None
    device = params0[names[0]].device
    for step, (data, seg) in enumerate(batches):
        x, t = inputs.augment(torch.from_numpy(data).to(device),
                              torch.from_numpy(seg).to(device), gen)
        if rows is not None:
            x, t = x[rows], t[rows]
        loss = ds_loss(model.forward(params, x, layers, quant), t.long(), factors)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        scale = torch.clamp(CLIP / norm, max=1.0)
        lr = poly_lr(step, iters_per_epoch)
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n]
                d = g * scale + WEIGHT_DECAY * p
                buf[n] = d.clone() if n not in buf else buf[n] * MOMENTUM + d
                p -= lr * (d + MOMENTUM * buf[n])
        if first is None:
            first = {n: buf[n].clone() for n in names}
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_update": first,
            "change": {n: (params[n] - params0[n]).detach() for n in names}}


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{leaf: the gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger}."""
    rn = {n: float(torch.linalg.vector_norm(ref[n])) for n in keep}
    med = float(np.median(list(rn.values())))
    return {n: abs(float(torch.linalg.vector_norm(prog[n].float())) - rn[n]) / max(rn[n], med)
            for n in keep}


def leaf_gap(prog: dict, ref: dict, keep) -> tuple:
    """The worst leaf's gap (``leaf_gaps``): (gap, leaf)."""
    return max((g, n) for n, g in leaf_gaps(prog, ref, keep).items())


def moving_leaves(first_update: dict, params0: dict) -> list:
    """The leaves whose first gradient (the buffer less the decay) is at
    least a thousandth of the median leaf's: those under it (a conv bias
    before an InstanceNorm, the coarsest head, whose loss weight is 0) move
    by round-off alone."""
    g = {n: float(torch.linalg.vector_norm(first_update[n] - WEIGHT_DECAY * params0[n]))
         for n in first_update}
    med = float(np.median(list(g.values())))
    return [n for n, v in g.items() if v >= 1e-3 * med]
