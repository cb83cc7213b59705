"""The continual-learning loss terms: the port of
``lifelong_nnunet_tpu/ops/cl_losses.py``.

  * EWC (the reference's ``deep_supervision.py:15-83``):
    lam/2 sum_t sum_i F_ti (theta_i - theta*_ti)^2
  * RW  (``deep_supervision.py:86-135``): lam sum_i (F_i + S_i)(theta_i - theta*_i)^2,
    with the EWC++ fisher EMA and the Riemannian-walk scores updated online
  * LwF (``deep_supervision.py:138-214``): KL of the earlier heads' logits
    to their teachers' at temperature T ('batchmean', no T^2 factor, as the
    JAX code computes it)
  * MiB (``deep_supervision.py:383-416``, ``knowledge_distillation.py:3-60``,
    ``crossentropy.py``): the unbiased cross-entropy and the unbiased
    knowledge distillation
  * PLOP / POD (``deep_supervision.py:217-380``, ``embeddings.py:3-42``):
    the multi-scale local POD distance between the student's and the
    teacher's intermediate activations, the entropy-thresholded pseudo-label
    loss and the per-class median-entropy thresholds

Parameters, fishers, scores and anchors are ``{state_dict key: tensor}``
dicts; a mask ``{key: bool}`` restricts the regularized keys.  Anchors may
be stored in bf16 and are upcast to f32 inside the penalty, as in the JAX
package (``:40-44``).  :func:`quadratic_penalty` and its two wrappers are
the plain formulas, differentiable by autograd.  The train step uses
:class:`QuadraticPenalty` instead: the same sum over the model's parameter
list with ``torch._foreach_*`` ops (a few launches per anchor, not a few
per tensor), its gradient written into ``.grad`` after the backward of the
base loss.

The distilling terms take channels-first logits and activations ``[B, C,
*spatial]``, the U-Net's layout, so the class axis the JAX functions reduce
over (``axis=-1``) is axis 1 here, and the two pooled axes of POD (the JAX
taps' axes -3 and -2, H and W) are dims -2 and -1; they are plain autograd
formulas, as the JAX package's are plain XLA.

Two departures from the JAX POD (``:201-243``), both where its value or
gradient is NaN: the row norms are ``torch.linalg.vector_norm``, whose
gradient at a zero norm is 0 (the reference's ``torch.norm``; JAX's
``sqrt(sum(d**2))`` gives NaN there, which is every first step of a new
task, where the student's taps equal the teacher's); and a region whose
slice is empty on either pooled axis is left out (on a non-square map the
reference's loop, which steps the H axis by the W-derived width and the W
axis by the H-derived height, runs past the shorter axis; JAX takes the
mean of that empty slice, NaN).  On every input where the JAX value is
finite both give it.
"""

from __future__ import annotations

import torch

from .losses import cross_entropy_loss, downsample_target, gmean, gsum


def quadratic_penalty(params: dict, anchors: list, lam: float, mask: dict | None = None,
                      use_half: bool = True) -> torch.Tensor:
    """Sum over ``anchors`` ({"weight": dict, "params": dict}) of lam (/2)
    sum_i w_i (theta_i - theta*_i)^2 over the keys of ``params`` that the
    anchor holds and ``mask`` does not exclude."""
    terms = []
    for anchor in anchors:
        for k, theta in params.items():
            if (mask is not None and not mask.get(k, True)) or k not in anchor["params"]:
                continue
            w = anchor["weight"][k].float()
            diff = theta.float() - anchor["params"][k].float()
            terms.append(torch.sum(w * diff * diff))
    total = torch.stack(terms).sum() if terms else torch.zeros(())
    return (lam / 2.0 if use_half else lam) * total


def ewc_penalty(params: dict, ewc_state: dict, lam: float,
                mask: dict | None = None) -> torch.Tensor:
    """EWC over every earlier task: ``ewc_state`` {task: {"fisher", "params"}}."""
    anchors = [{"weight": t["fisher"], "params": t["params"]} for t in ewc_state.values()]
    return quadratic_penalty(params, anchors, lam, mask, use_half=True)


def rw_penalty(params: dict, fisher: dict, scores: dict, anchor_params: dict, lam: float,
               mask: dict | None = None) -> torch.Tensor:
    """The Riemannian-walk penalty lam sum (F + S)(theta - theta*)^2 (no
    half); the running fisher of the current task is not in it."""
    weight = {k: fisher[k] + scores[k] for k in fisher}
    return quadratic_penalty(params, [{"weight": weight, "params": anchor_params}], lam,
                             mask, use_half=False)


def rw_online_update(fisher: dict, scores: dict, grads: dict, prev_params: dict,
                     curr_params: dict, loss_prev, loss_curr, alpha: float = 0.9,
                     eps: float = 1e-8):
    """The EWC++ fisher EMA ``F <- alpha g^2 + (1 - alpha) F`` and the RW
    scores ``S += max(0, dloss / (F dtheta^2 / 2 + eps))`` with ``dloss =
    loss_prev - loss_curr`` (0-d tensors or floats, never read on the
    host).  Returns new (fisher, scores) dicts; the inputs are not
    changed."""
    keys = list(fisher)
    g = [grads[k].float() for k in keys]
    f = torch._foreach_mul(g, g)
    torch._foreach_mul_(f, alpha)
    torch._foreach_add_(f, torch._foreach_mul([fisher[k] for k in keys], 1 - alpha))
    dtheta = torch._foreach_sub([curr_params[k].float() for k in keys],
                                [prev_params[k].float() for k in keys])
    denom = torch._foreach_mul(f, 0.5)
    torch._foreach_mul_(denom, dtheta)
    torch._foreach_mul_(denom, dtheta)
    torch._foreach_add_(denom, eps)
    dl = torch.as_tensor(loss_prev, dtype=torch.float32, device=f[0].device) - loss_curr
    s = torch._foreach_reciprocal(denom)
    torch._foreach_mul_(s, dl)
    torch._foreach_clamp_min_(s, 0.0)
    new_scores = torch._foreach_add([scores[k] for k in keys], s)
    return dict(zip(keys, f)), dict(zip(keys, new_scores))


def normalize_scores(scores: dict, eps: float = 1e-8) -> dict:
    """Min-max normalization over all tensors jointly."""
    lo = torch.stack([v.min() for v in scores.values()]).min()
    hi = torch.stack([v.max() for v in scores.values()]).max()
    return {k: (v - lo) / (hi - lo + eps) for k, v in scores.items()}


class QuadraticPenalty:
    """:func:`quadratic_penalty` of the live parameters ``named`` ({key:
    parameter}) for the train step, as ``torch._foreach_*`` ops over tensor
    lists.  Each anchor covers the keys of ``named`` that it holds and
    ``mask`` keeps; anchors may hold different keys (EWC-LN with
    task-specific LayerNorms: a later task's anchor also holds that task's
    set), and anchors over the same keys form one group whose gradients are
    summed before they reach ``.grad``.  The anchors are upcast to f32
    once, here, since they do not change while a task trains.  The weights
    must be non negative (squared gradients, normalized scores): each
    tensor's sum of w (theta - theta*)^2 is then its L1 norm.

    Called as a ``loss_extras`` hook, ``(model, cl_state, model_out,
    batch) -> (value, {name: value})``, it returns the value without an
    autograd graph and keeps w (theta - theta*) summed over each group's
    anchors; :meth:`add_grad` adds that times 2 lam (/2) to the
    parameters' ``.grad`` after the backward."""

    def __init__(self, named: dict, anchors: list, lam: float, mask: dict | None = None,
                 use_half: bool = True, name: str = "penalty"):
        self.groups = {}      # keys -> [(weights, anchor params)]
        for a in anchors:
            keys = tuple(k for k in named if (mask is None or mask.get(k, True))
                         and k in a["params"])
            if keys:
                self.groups.setdefault(keys, []).append(
                    ([a["weight"][k].float() for k in keys],
                     [a["params"][k].float() for k in keys]))
        self.params = {keys: [named[k] for k in keys] for keys in self.groups}
        self.factor = lam / 2.0 if use_half else lam
        self.name = name
        self._grad = None

    def __call__(self, *_unused):
        grads, total = {}, None
        with torch.no_grad():
            # an anchor may hold none of these parameters (EWC on the ViT's
            # parameters of a U-Net): the penalty is then 0
            for keys, anchors in self.groups.items():
                params = self.params[keys]
                for weight, anchor in anchors:
                    diff = torch._foreach_sub(params, anchor)
                    wd = torch._foreach_mul(diff, weight)
                    sums = torch._foreach_norm(torch._foreach_mul(wd, diff), 1)
                    part = torch.stack(sums).sum()
                    total = part if total is None else total + part
                    if keys in grads:
                        torch._foreach_add_(grads[keys], wd)
                    else:
                        grads[keys] = wd
            if total is None:
                total = torch.zeros((), dtype=torch.float32)
            value = total * self.factor
        self._grad = grads or None
        return value, {self.name: value}

    def add_grad(self) -> None:
        """Add the last call's gradient to the parameters' ``.grad`` (a
        parameter the backward left without one gets it as its gradient)."""
        if self._grad is None:
            return
        for keys, grad in self._grad.items():
            params = self.params[keys]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            torch._foreach_add_([p.grad for p in params], grad, alpha=2.0 * self.factor)
        self._grad = None


# ------------------------------------------------------------------ LwF / MiB

def lwf_distill_loss(current_logits: list, target_logits: list,
                     temperature: float = 2.0, dp=None) -> torch.Tensor:
    """Sum over the earlier heads of KL(teacher^T || current^T) with
    'batchmean' reduction: the sum over voxels and classes divided by the
    batch size only (the reference's ``F.kl_div(..., reduction='batchmean',
    log_target=True)``).  The logits are the full-resolution outputs."""
    total = 0.0
    for cur, tgt in zip(current_logits, target_logits):
        logp = torch.log_softmax(cur.float() / temperature, dim=1)
        logq = torch.log_softmax(tgt.float() / temperature, dim=1)
        batch = cur.shape[0] * (1 if dp is None else dp.size)
        total = total + gsum((logq.exp() * (logq - logp)).sum(), dp) / batch
    return total


def unbiased_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           old_num_classes: int, ignore: int = -1, dp=None) -> torch.Tensor:
    """MiB's unbiased CE: the background's log-probability absorbs every
    old class (< ``old_num_classes``), and every target label below
    ``old_num_classes`` collapses to 0; the mean over the voxels whose
    target is not ``ignore``."""
    num_classes = logits.shape[1]
    logits = logits.float()
    den = torch.logsumexp(logits, dim=1)
    log_old_bg = torch.logsumexp(logits[:, :old_num_classes], dim=1) - den
    log_probs = torch.log_softmax(logits, dim=1)
    labels = torch.where((target >= 0) & (target < old_num_classes),
                         torch.zeros_like(target), target)
    tgt = labels.clamp(0, num_classes - 1).long()
    picked = log_probs.gather(1, tgt.unsqueeze(1)).squeeze(1)
    picked = torch.where(labels == 0, log_old_bg, picked)
    valid = (target != ignore).float()
    return -gsum((picked * valid).sum(), dp) / gsum(valid.sum(), dp).clamp(min=1.0)


def unbiased_kd_loss(logits: torch.Tensor, teacher_logits: torch.Tensor,
                     old_num_classes: int, alpha: float = 1.0, dp=None) -> torch.Tensor:
    """MiB's unbiased knowledge distillation: the teacher's probabilities
    over its ``old_num_classes`` channels against the student's
    log-probabilities where the background absorbs every new class; each
    voxel's sum is divided by ``old_num_classes`` before the mean."""
    x = logits.float()
    t = teacher_logits.float() * alpha
    den = torch.logsumexp(x, dim=1, keepdim=True)
    log_bg = torch.logsumexp(torch.cat([x[:, :1], x[:, old_num_classes:]], dim=1),
                             dim=1, keepdim=True) - den
    student_log = torch.cat([log_bg, x[:, 1:old_num_classes] - den], dim=1)
    q = torch.softmax(t[:, :old_num_classes], dim=1)
    return -gmean((q * student_log).sum(dim=1) / old_num_classes, dp)


def mib_loss(outputs: list, teacher_outputs: list, target: torch.Tensor, ds_weights,
             ds_factors, old_num_classes: int, lkd: float = 10.0,
             alpha: float = 0.9, dp=None) -> torch.Tensor:
    """MiB's objective: per deep-supervision output of nonzero weight, the
    plain CE (the reference's ``RobustCrossEntropyLoss``, not the unbiased
    one) plus ``lkd`` times the unbiased KD, weighted; ``target`` is the
    full-resolution label map, downsampled by ``ds_factors``."""
    total = 0.0
    for w, out, tout, f in zip(ds_weights, outputs, teacher_outputs, ds_factors):
        if w == 0.0:
            continue
        ce = cross_entropy_loss(out.float(), downsample_target(target, f), dp=dp)
        kd = unbiased_kd_loss(out, tout, old_num_classes, alpha, dp=dp)
        total = total + float(w) * (ce + lkd * kd)
    return total


# ------------------------------------------------------------------ PLOP / POD

def entropy(probs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-voxel entropy as the reference computes it: ``-(1 / log(C + eps))
    * mean_c p log(p + eps)`` over the class axis (dim 1) -- the channel
    MEAN, so values lie in [0, 1/C]."""
    # in f32, as the JAX package computes it
    factor = 1.0 / torch.log(torch.tensor(probs.shape[1] + eps, device=probs.device))
    return -factor * (probs * torch.log(probs + eps)).mean(dim=1)


def entropy_confidence(probs: torch.Tensor) -> torch.Tensor:
    """The statistic PLOP's thresholds live in: :func:`entropy` over
    ``log(C)``."""
    return entropy(probs) / torch.log(torch.tensor(float(probs.shape[1]),
                                                   device=probs.device))


def pod_embed(act: torch.Tensor) -> torch.Tensor:
    """The reference's ``pod_embed``: ``act [B, C, *lead, h, w]`` mean-pooled
    over w and over h separately, concatenated over channels ->
    ``[B, 2C, *lead, h]`` (needs h == w)."""
    return torch.cat([act.mean(dim=-1), act.mean(dim=-2)], dim=1)


def pod_regions(H: int, W: int, scales: int) -> list:
    """(i, j, w, h) of each region of the reference's ``local_POD`` sweep on
    a map of pooled dims H x W: at scale s, w = int(W / 2^s) and h = int(H /
    2^s); ``i`` runs over ``range(0, W - w, w)`` and slices the H axis, ``j``
    over ``range(0, H - h, h)`` and slices W (the reference's axis swap;
    slices past an edge are clamped), so scale 0 and the last region of
    every scale add nothing.  A region whose slice would be empty on either
    axis is left out (the module docstring)."""
    out = []
    for scale in range(scales):
        w, h = int(W / (2 ** scale)), int(H / (2 ** scale))
        if w <= 0 or h <= 0:
            raise ValueError(f"POD scales={scales} too large for spatial dims ({H},{W})")
        out += [(i, j, w, h) for i in range(0, W - w, w) for j in range(0, H - h, h)
                if i < H and j < W]
    return out


def pod_scales(H: int, W: int, scales: int) -> int:
    """The scales ``local_pod_loss`` sweeps on an H x W map: ``scales``
    clamped to ``min(H, W).bit_length()`` (the JAX package's, where the
    reference's loop would take a zero step)."""
    return max(1, min(scales, min(H, W).bit_length()))


def _pod_blocks(act: torch.Tensor, scales: int):
    """The width-pooled rows ``[B, C, *lead, sum of the regions' heights]``
    and the height-pooled rows (the regions' widths) of ``act [B, C, *lead,
    H, W]`` over :func:`pod_regions`, or (None, None) without a region."""
    regions = pod_regions(act.shape[-2], act.shape[-1], scales)
    if not regions:
        return None, None
    actf = act.float()
    slices = [actf[..., i:i + w, j:j + h] for i, j, w, h in regions]
    return (torch.cat([sl.mean(dim=-1) for sl in slices], dim=-1),
            torch.cat([sl.mean(dim=-2) for sl in slices], dim=-1))


def local_pod_distance(act: torch.Tensor, teacher_act: torch.Tensor,
                       scales: int = 3, dp=None) -> torch.Tensor:
    """The reference's ``local_POD``: the L2 norm of each (channel, pooled
    axis) row of the concatenated regions' differences, then the mean over
    all rows, both pooled blocks weighted alike; 0 without a region."""
    pw, ph = _pod_blocks(act, scales)
    ow, oh = _pod_blocks(teacher_act, scales)
    if pw is None:
        return torch.zeros((), device=act.device)
    dw = torch.linalg.vector_norm(pw - ow, dim=-1)
    dh = torch.linalg.vector_norm(ph - oh, dim=-1)
    return (gmean(dw, dp) + gmean(dh, dp)) / 2.0


def pod_embedding(act: torch.Tensor, scales: int = 3) -> torch.Tensor:
    """The flattened multi-scale POD rows ``[B, F]`` (both blocks of
    :func:`_pod_blocks`; :func:`pod_embed` when there is no region).  L2
    distances between these are not the reference metric: that is
    :func:`local_pod_distance`."""
    pw, ph = _pod_blocks(act, scales)
    if pw is None:
        e = pod_embed(act.float())
        return e.reshape(e.shape[0], -1)
    b = pw.shape[0]
    return torch.cat([pw.reshape(b, -1), ph.reshape(b, -1)], dim=-1)


def local_pod_loss(taps: dict, teacher_taps: dict, scales: int = 3,
                   pod_lambda: float = 1e-2, dp=None) -> torch.Tensor:
    """The POD term as the reference composes it: over the common tap names
    in ``sorted()`` order, add ``pod_lambda * local_POD`` and divide the
    RUNNING total by the number of layers inside the loop.  Each map's
    scales are clamped by :func:`pod_scales`."""
    keys = sorted(set(taps) & set(teacher_taps))
    if not keys:
        return torch.zeros(())
    dist = 0.0
    for k in keys:
        eff = pod_scales(taps[k].shape[-2], taps[k].shape[-1], scales)
        dist = (dist + pod_lambda * local_pod_distance(taps[k], teacher_taps[k], eff, dp)) \
            / len(keys)
    return dist


def _teacher_stats(teacher_logits: torch.Tensor):
    """The teacher's (entropy confidence, argmax) per voxel, in f32."""
    probs = torch.softmax(teacher_logits.float(), dim=1)
    return entropy_confidence(probs), probs.argmax(dim=1)


def plop_pseudo_targets(target: torch.Tensor, teacher_logits: torch.Tensor,
                        thresholds: torch.Tensor, num_classes: int):
    """PLOP's pseudo-labels: where the ground truth is background, the
    teacher's argmax if its entropy confidence is below that class's
    threshold, else ignore (-1).  Returns (pseudo target, the confident
    share of the background voxels)."""
    ent, pred = _teacher_stats(teacher_logits)
    confident = ent < thresholds[pred]
    is_bg = target == 0
    pseudo = torch.where(is_bg & confident, pred, target)
    pseudo = torch.where(is_bg & ~confident, torch.full_like(pseudo, -1), pseudo)
    num = (is_bg & confident).float().sum()
    den = is_bg.float().sum().clamp(min=1.0)
    return pseudo.int(), num / den


def _ce_mean(logits: torch.Tensor, target: torch.Tensor, ignore: int = -1,
             dp=None) -> torch.Tensor:
    """Mean CE over the voxels whose target is not ``ignore``, over the
    whole batch; 0 when every voxel is ignored (``F.cross_entropy``'s mean
    is NaN there)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    tgt = target.clamp(0, logits.shape[1] - 1).long()
    picked = logp.gather(1, tgt.unsqueeze(1)).squeeze(1)
    valid = (target != ignore).float()
    return -gsum((picked * valid).sum(), dp) / gsum(valid.sum(), dp).clamp(min=1.0)


def plop_pseudo_label_loss(logits: torch.Tensor, teacher_logits: torch.Tensor,
                           target: torch.Tensor, thresholds: torch.Tensor,
                           dp=None) -> torch.Tensor:
    """One deep-supervision output's PLOP objective: with B the background
    mask and V the teacher-confident mask, the CE on B & V against the
    teacher's argmax plus the CE on the rest against the true labels, both
    means over the batch, times the batch mean of each item's |B & V| / |B|."""
    ent, pseudo = _teacher_stats(teacher_logits)
    confident = ent < thresholds[pseudo]
    is_bg = target == 0
    pv = is_bg & confident
    ignore = torch.full_like(target, -1)
    lab_not = torch.where(pv, ignore, target)
    lab_ps = torch.where(pv, pseudo.to(target.dtype), ignore)
    axes = tuple(range(1, target.dim()))
    num = pv.float().sum(dim=axes)
    den = is_bg.float().sum(dim=axes).clamp(min=1.0)
    factor = gmean(num / den, dp)
    return factor * (_ce_mean(logits, lab_ps, dp=dp) + _ce_mean(logits, lab_not, dp=dp))


def median_entropy_thresholds(entropy_sums: torch.Tensor,
                              base_threshold: float = 0.001) -> torch.Tensor:
    """Per-class thresholds ``[C]`` from the confidence histogram ``[C, BINS]``
    over [0, 1]: the centre of the median bin, floored at
    ``base_threshold``."""
    bins = entropy_sums.shape[1]
    cum = torch.cumsum(entropy_sums, dim=1)
    half = cum[:, -1:] / 2.0
    median_bin = torch.argmax((cum >= half).to(torch.uint8), dim=1)
    return ((median_bin.float() + 0.5) / bins).clamp(min=base_threshold)


def accumulate_entropy_histogram(hist: torch.Tensor, teacher_logits: torch.Tensor,
                                 target: torch.Tensor, num_classes: int,
                                 bins: int = 100) -> torch.Tensor:
    """``hist [C, bins]`` plus one batch's counts: over the background voxels
    of ``target``, the teacher's entropy confidence binned over [0, 1] in the
    row of the teacher's argmax class."""
    ent, pred = _teacher_stats(teacher_logits)
    idx = (ent * bins).to(torch.int64).clamp(0, bins - 1)
    cls = torch.where(target == 0, pred, torch.full_like(pred, num_classes))
    counts = torch.bincount((cls * bins + idx).reshape(-1),
                            minlength=(num_classes + 1) * bins)
    return hist + counts[: num_classes * bins].view(num_classes, bins).float()
