"""The regularizing continual-learning terms, EWC and RW: the port of the
EWC/RW part of ``lifelong_nnunet_tpu/ops/cl_losses.py`` (``:29-92``).

  * EWC (the reference's ``deep_supervision.py:15-83``):
    lam/2 sum_t sum_i F_ti (theta_i - theta*_ti)^2
  * RW  (``deep_supervision.py:86-135``): lam sum_i (F_i + S_i)(theta_i - theta*_i)^2,
    with the EWC++ fisher EMA and the Riemannian-walk scores updated online

Parameters, fishers, scores and anchors are ``{state_dict key: tensor}``
dicts; a mask ``{key: bool}`` restricts the regularized keys.  Anchors may
be stored in bf16 and are upcast to f32 inside the penalty, as in the JAX
package (``:40-44``).  :func:`quadratic_penalty` and its two wrappers are
the plain formulas, differentiable by autograd.  The train step uses
:class:`QuadraticPenalty` instead: the same sum over the model's parameter
list with ``torch._foreach_*`` ops (a few launches per anchor, not a few
per tensor), its gradient written into ``.grad`` after the backward of the
base loss.  The distilling terms of the JAX file (LwF, MiB, POD, PLOP) are
not ported yet.
"""

from __future__ import annotations

import torch


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
