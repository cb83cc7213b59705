"""The EWC trainers: the port of
``lifelong_nnunet_tpu/training/trainers/ewc.py`` (``:30-146``).

``EWCTrainer`` adds lam/2 sum_t sum_i F_ti (theta_i - theta*_ti)^2 over every
earlier task t to the loss (``ops/cl_losses.py:QuadraticPenalty``, its
gradient written into ``.grad``).  After each task a fisher pass runs
``iters_per_epoch`` training batches (sampler seed offset 777, augmented
when ``opts.augment`` is set) through a backward with no optimizer step
and averages ``grad(base loss)^2`` over them in f32; the task's fisher and
its parameters are kept in ``cl_state["ewc_tasks"][task]`` in **bf16**, as
the JAX package keeps them (``:119-125``), and upcast to f32 in the
penalty.  The manifest records that dtype (``anchor_dtype``).

Three points follow the JAX package where the reference differs or is not
checked (ROADMAP Queue 3): the fisher is the epoch's average, where the
reference's code keeps the last batch's grad^2; the anchors are bf16; and
the fisher and anchors are keyed by the assembled model's ``state_dict``
keys, so a new task's seg head carries the old task's head keys and the
penalty reaches it.

Over several ranks the fisher pass draws each rank's rows of the global
batches and squares the gradient summed over the data ranks (the global
batch's, as JAX's jitted gradient of the sharded batch), never a rank's
own; under model parallelism the fisher and the anchors are the rank's
slices while it trains and whole in every checkpoint.

The variants regularize a subset of the parameters, chosen by name
(``models/multihead.py:name_filter_mask``): ``ewc_vit`` the ViT's,
``ewc_unet`` all but the ViT's, ``ewc_ln`` the ViT's LayerNorms.
"""

from __future__ import annotations

import torch

from ...data.augment import AugmentConfig, augment_batch
from ...models.multihead import name_filter_mask
from ...ops.cl_losses import QuadraticPenalty
from ...ops.losses import deep_supervision_loss
from ..trainer import SEED, MultiHeadTrainer

DEFAULT_EWC_LAMBDA = 0.4   # the reference's run_training.py default
ANCHOR_DTYPE = torch.bfloat16
FISHER_SEED_OFFSET = 777   # the JAX trainer's fisher sampler


class EWCTrainer(MultiHeadTrainer):
    EXTENSION = "ewc"
    TRANSFER_HEADS = False
    HYPERPARAMS = {"ewc_lambda": float}
    # (substrings, include) of the regularized parameters' names; None: all
    PARAM_FILTER: tuple | None = None

    def __init__(self, *args, ewc_lambda: float = DEFAULT_EWC_LAMBDA, **kw):
        kw.setdefault("ewc_lambda", ewc_lambda)
        super().__init__(*args, **kw)
        self.ewc_lambda = float(ewc_lambda)

    def init_cl_state(self):
        return {"ewc_tasks": {}}

    def _mask(self) -> dict | None:
        if self.PARAM_FILTER is None:
            return None
        subs, include = self.PARAM_FILTER
        return name_filter_mask(self.model.state_dict(), list(subs), include)

    def loss_extras(self):
        tasks = self.cl_state["ewc_tasks"]
        if not tasks:
            return None
        anchors = [{"weight": t["fisher"], "params": t["params"]} for t in tasks.values()]
        return QuadraticPenalty(dict(self.model.named_parameters()), anchors,
                                self.ewc_lambda, self._mask(), use_half=True,
                                name="ewc_penalty")

    def extra_manifest(self) -> dict:
        return {"anchor_dtype": str(ANCHOR_DTYPE).replace("torch.", "")}

    def after_task(self, task: str):
        """The fisher pass over one epoch of training batches, then the
        task's fisher and parameters into ``cl_state`` (bf16)."""
        named = dict(self.model.named_parameters())
        mask = self._mask()
        keep = [k for k in named if mask is None or mask[k]]
        params = list(named.values())
        fisher = [torch.zeros_like(named[k], dtype=torch.float32) for k in keep]
        aug = AugmentConfig(dummy_2d=bool(getattr(self.cfg, "do_dummy_2d_aug", False))) \
            if self.opts.augment else None
        gen = torch.Generator(device=self.device).manual_seed(SEED * 1000 + FISHER_SEED_OFFSET)
        sampler = self._make_sampler(task, True, seed_offset=FISHER_SEED_OFFSET)
        n = self.opts.iters_per_epoch
        self.model.train()
        at = {k: i for i, k in enumerate(named)}
        for _ in range(n):
            b = sampler.next_batch()
            data = torch.from_numpy(b["data"]).to(self.device)
            seg = torch.from_numpy(b["seg"]).to(self.device)
            if aug is not None:
                data, seg = augment_batch(data, seg, aug, gen, rows=self._global_rows())
            loss = deep_supervision_loss(self.model(data), seg.long(), self.ds_factors,
                                         self.batch_dice, dp=self.dp)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            # a parameter the loss does not reach (the coarsest deep-
            # supervision head, weight 0) has gradient 0, as under jax.grad
            g = [grads[at[k]] if grads[at[k]] is not None else torch.zeros_like(named[k])
                 for k in keep]
            if self.dp is not None:
                # the global batch's gradient, as JAX's on the sharded batch
                self.dp.sum_flat_(g)
            torch._foreach_addcmul_(fisher, g, g)
        torch._foreach_div_(fisher, n)
        self.cl_state["ewc_tasks"][task] = {
            "fisher": {k: f.to(ANCHOR_DTYPE) for k, f in zip(keep, fisher)},
            "params": {k: named[k].detach().to(ANCHOR_DTYPE, copy=True) for k in keep},
        }
        self.logger(f"[{task}] EWC fisher computed over {n} batches "
                    f"({len(keep)}/{len(named)} param tensors)")


class EWCViTTrainer(EWCTrainer):
    """EWC on the ViT's parameters only."""
    EXTENSION = "ewc_vit"
    PARAM_FILTER = (["vit"], True)


class EWCUNetTrainer(EWCTrainer):
    """EWC on every parameter but the ViT's."""
    EXTENSION = "ewc_unet"
    PARAM_FILTER = (["vit"], False)


class EWCLNTrainer(EWCTrainer):
    """EWC on the ViT's LayerNorms only."""
    EXTENSION = "ewc_ln"
    PARAM_FILTER = (["vit", "norm"], True)
