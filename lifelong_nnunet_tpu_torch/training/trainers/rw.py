"""The RW trainer (Riemannian Walk with the EWC++ fisher): the port of
``lifelong_nnunet_tpu/training/trainers/rw.py`` (``:25-117``).

Every ``fisher_update_after`` iterations (iterations 0, n, 2n, ... of the
whole run) the running fisher becomes ``alpha g^2 + (1 - alpha) F`` and the
scores gain ``max(0, dloss / (F dtheta^2 / 2 + eps))``, from the gradients
of the total loss before the clip, the parameters before the update and
those of the last update (``ops/cl_losses.py:rw_online_update``).  The
JAX step computes the update every iteration and selects it with
``jnp.where``; here a host counter (``cl_state["running"]["iter"]``, an int)
gates it, so the step neither syncs nor reads a value back.  The previous
loss starts at 0, so the first update's dloss is negative and adds no
score.  After each task the scores are min-max normalized and kept in
``score_sets`` in bf16, the anchor (f32) takes the running fisher, the
average of the score sets (in f32) and the parameters, and the running
scores restart at 0.  The penalty lam sum (F + S)(theta - theta*)^2 runs
from the second task on.

The JAX package records only ``rw_lambda`` among the hyperparameters
(its ``__init__``), so ``rw_alpha`` and ``fisher_update_after`` also go
into the checkpoint's manifest (``rw``) and come back from it.
"""

from __future__ import annotations

import torch

from ...ops.cl_losses import QuadraticPenalty, normalize_scores, rw_online_update
from ..trainer import MultiHeadTrainer


class RWTrainer(MultiHeadTrainer):
    EXTENSION = "rw"
    TRANSFER_HEADS = False
    HYPERPARAMS = {"rw_lambda": float, "rw_alpha": float, "fisher_update_after": int}

    def __init__(self, *args, rw_lambda: float = 0.4, rw_alpha: float = 0.9,
                 fisher_update_after: int = 10, **kw):
        kw.setdefault("rw_lambda", rw_lambda)
        super().__init__(*args, **kw)
        self.rw_lambda = float(rw_lambda)
        self.rw_alpha = float(rw_alpha)
        self.fisher_update_after = int(fisher_update_after)

    def init_cl_state(self):
        return {"running": None, "anchor": None, "score_sets": [], "num_tasks_done": 0}

    def extra_manifest(self) -> dict:
        return {"anchor_dtype": "float32", "score_sets_dtype": "bfloat16",
                "rw": {"rw_alpha": self.rw_alpha,
                       "fisher_update_after": self.fisher_update_after}}

    def _adopt_manifest(self, manifest: dict):
        rw = manifest.get("rw") or {}
        self.rw_alpha = float(rw.get("rw_alpha", self.rw_alpha))
        self.fisher_update_after = int(rw.get("fisher_update_after",
                                              self.fisher_update_after))

    def before_task(self, task: str):
        if self.cl_state["running"] is None:
            flat = {k: v.detach().to(self.device, torch.float32, copy=True)
                    for k, v in self.mh.assemble(task).items()}
            self.cl_state["running"] = {
                "fisher": {k: torch.zeros_like(v) for k, v in flat.items()},
                "scores": {k: torch.zeros_like(v) for k, v in flat.items()},
                "prev_params": flat,
                "prev_loss": torch.zeros((), device=self.device),
                "iter": 0,
            }

    def loss_extras(self):
        anchor = self.cl_state.get("anchor")
        if anchor is None:
            return None
        keys = list(anchor["fisher"])
        weight = dict(zip(keys, torch._foreach_add([anchor["fisher"][k] for k in keys],
                                                   [anchor["scores"][k] for k in keys])))
        return QuadraticPenalty(dict(self.model.named_parameters()),
                                [{"weight": weight, "params": anchor["params"]}],
                                self.rw_lambda, use_half=False, name="rw_penalty")

    def cl_state_update(self):
        alpha, every = self.rw_alpha, self.fisher_update_after

        def update(cl_state, model, loss):
            r = cl_state["running"]
            if r["iter"] % every == 0:
                named = dict(model.named_parameters())
                keys = list(r["fisher"])
                grads = {k: named[k].grad if named[k].grad is not None
                         else torch.zeros_like(named[k]) for k in keys}
                params = {k: named[k].detach() for k in keys}
                fisher, scores = rw_online_update(r["fisher"], r["scores"], grads,
                                                  r["prev_params"], params, r["prev_loss"],
                                                  loss, alpha=alpha)
                prev = [r["prev_params"][k] for k in keys]
                torch._foreach_copy_(prev, [params[k] for k in keys])
                r = {**r, "fisher": fisher, "scores": scores, "prev_loss": loss.detach()}
            return {**cl_state, "running": {**r, "iter": r["iter"] + 1}}

        return update

    def after_task(self, task: str):
        """Normalize the scores, average the score sets into the anchor,
        snapshot the fisher and the parameters."""
        r = self.cl_state["running"]
        norm = {k: v.to(torch.bfloat16) for k, v in normalize_scores(r["scores"]).items()}
        sets = self.cl_state["score_sets"] + [norm]
        n = len(sets)
        avg = {k: sum(s[k].float() for s in sets) / n for k in norm}
        params = {k: v.detach().to(self.device, torch.float32, copy=True)
                  for k, v in self.mh.assemble(task).items()}
        self.cl_state = {
            "running": {**r, "scores": {k: torch.zeros_like(v)
                                        for k, v in r["scores"].items()}},
            # rw_online_update makes new tensors: the running fisher is
            # never written in place, so the anchor may share it
            "anchor": {"fisher": dict(r["fisher"]),
                       "scores": avg, "params": params},
            "score_sets": sets,
            "num_tasks_done": self.cl_state["num_tasks_done"] + 1,
        }
        self.logger(f"[{task}] RW anchor updated ({n} score sets averaged)")
