"""The continual-learning loss terms: the port of the EWC/RW and LwF/MiB
parts of ``lifelong_nnunet_tpu/ops/cl_losses.py`` (``:29-170``).

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

Parameters, fishers, scores and anchors are ``{state_dict key: tensor}``
dicts; a mask ``{key: bool}`` restricts the regularized keys.  Anchors may
be stored in bf16 and are upcast to f32 inside the penalty, as in the JAX
package (``:40-44``).  :func:`quadratic_penalty` and its two wrappers are
the plain formulas, differentiable by autograd.  The train step uses
:class:`QuadraticPenalty` instead: the same sum over the model's parameter
list with ``torch._foreach_*`` ops (a few launches per anchor, not a few
per tensor), its gradient written into ``.grad`` after the backward of the
base loss.

The distilling terms take channels-first logits ``[B, C, *spatial]``, the
U-Net's layout, so the class axis the JAX functions reduce over
(``axis=-1``) is axis 1 here; they are plain autograd formulas, as the JAX
package's are plain XLA.  POD and PLOP (``:173-373``) are not ported yet.
"""

from __future__ import annotations

import torch

from .losses import cross_entropy_loss, downsample_target


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
    lists.  Every anchor must cover the same keys (those of ``named`` that
    it holds and ``mask`` keeps); the anchors are upcast to f32 once, here,
    since they do not change while a task trains.  The weights must be non
    negative (squared gradients, normalized scores): each tensor's sum of
    w (theta - theta*)^2 is then its L1 norm.

    Called as a ``loss_extras`` hook, ``(model, cl_state, model_out,
    batch) -> (value, {name: value})``, it returns the value without an
    autograd graph and keeps w (theta - theta*) summed over the anchors;
    :meth:`add_grad` adds that times 2 lam (/2) to the parameters' ``.grad``
    after the backward."""

    def __init__(self, named: dict, anchors: list, lam: float, mask: dict | None = None,
                 use_half: bool = True, name: str = "penalty"):
        keys = None
        for anchor in anchors:
            held = [k for k in named if (mask is None or mask.get(k, True))
                    and k in anchor["params"]]
            if keys is not None and held != keys:
                raise ValueError("every anchor of a QuadraticPenalty must cover the same keys")
            keys = held
        self.keys = keys or []
        self.params = [named[k] for k in self.keys]
        self.anchors = [([a["weight"][k].float() for k in self.keys],
                         [a["params"][k].float() for k in self.keys]) for a in anchors]
        self.factor = lam / 2.0 if use_half else lam
        self.name = name
        self._grad = None

    def __call__(self, *_unused):
        grad, total = None, None
        with torch.no_grad():
            for weight, anchor in self.anchors:
                diff = torch._foreach_sub(self.params, anchor)
                wd = torch._foreach_mul(diff, weight)
                sums = torch._foreach_norm(torch._foreach_mul(wd, diff), 1)
                part = torch.stack(sums).sum()
                total = part if total is None else total + part
                if grad is None:
                    grad = wd
                else:
                    torch._foreach_add_(grad, wd)
            if total is None:
                total = torch.zeros((), dtype=torch.float32)
            value = total * self.factor
        self._grad = grad
        return value, {self.name: value}

    def add_grad(self) -> None:
        """Add the last call's gradient to the parameters' ``.grad`` (a
        parameter the backward left without one gets it as its gradient)."""
        if self._grad is None:
            return
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_add_([p.grad for p in self.params], self._grad,
                            alpha=2.0 * self.factor)
        self._grad = None


# ------------------------------------------------------------------ LwF / MiB

def lwf_distill_loss(current_logits: list, target_logits: list,
                     temperature: float = 2.0) -> torch.Tensor:
    """Sum over the earlier heads of KL(teacher^T || current^T) with
    'batchmean' reduction: the sum over voxels and classes divided by the
    batch size only (the reference's ``F.kl_div(..., reduction='batchmean',
    log_target=True)``).  The logits are the full-resolution outputs."""
    total = 0.0
    for cur, tgt in zip(current_logits, target_logits):
        logp = torch.log_softmax(cur.float() / temperature, dim=1)
        logq = torch.log_softmax(tgt.float() / temperature, dim=1)
        total = total + (logq.exp() * (logq - logp)).sum() / cur.shape[0]
    return total


def unbiased_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           old_num_classes: int, ignore: int = -1) -> torch.Tensor:
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
    return -(picked * valid).sum() / valid.sum().clamp(min=1.0)


def unbiased_kd_loss(logits: torch.Tensor, teacher_logits: torch.Tensor,
                     old_num_classes: int, alpha: float = 1.0) -> torch.Tensor:
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
    return -((q * student_log).sum(dim=1) / old_num_classes).mean()


def mib_loss(outputs: list, teacher_outputs: list, target: torch.Tensor, ds_weights,
             ds_factors, old_num_classes: int, lkd: float = 10.0,
             alpha: float = 0.9) -> torch.Tensor:
    """MiB's objective: per deep-supervision output of nonzero weight, the
    plain CE (the reference's ``RobustCrossEntropyLoss``, not the unbiased
    one) plus ``lkd`` times the unbiased KD, weighted; ``target`` is the
    full-resolution label map, downsampled by ``ds_factors``."""
    total = 0.0
    for w, out, tout, f in zip(ds_weights, outputs, teacher_outputs, ds_factors):
        if w == 0.0:
            continue
        ce = cross_entropy_loss(out.float(), downsample_target(target, f))
        kd = unbiased_kd_loss(out, tout, old_num_classes, alpha)
        total = total + float(w) * (ce + lkd * kd)
    return total
