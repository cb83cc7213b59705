"""Optimizer + LR schedule: nnU-Net's recipe as the JAX package's optax
chain (``lifelong_nnunet_tpu/training/optimizer.py``), in PyTorch.

The chain, in this order: clip the gradients at global norm 12, add weight
decay 3e-5 * param to them, then SGD with Nesterov momentum 0.99 at the
poly learning rate ``lr0 * (1 - epoch / max_epochs)^0.9`` with
``epoch = step // iters_per_epoch``.  ``torch.optim.SGD`` with
``weight_decay`` adds the decay after clipping and before the momentum
buffer, and its Nesterov update ``p -= lr * (g + m * buf)`` is optax's
``trace(nesterov=True)`` followed by the scale by -lr.  ``torch.optim.SGD``
skips a parameter whose ``.grad`` is None, where optax updates every leaf
(a zero gradient still decays it): so the step gives such a parameter a
zero gradient first, as the fused conv's Function does for the conv bias
(``ops/kernels/conv3d.py``); the coarsest deep-supervision head, whose
loss weight is 0, is the other case.

The poly LR follows the optimizer's own step count, as optax's schedule
follows its own count: a trainer builds a fresh optimizer for every task,
so the count starts again at 0 for each task, and a resumed task takes it
back from the checkpoint (:meth:`PolySGD.load_state_dict`), never from the
trainer's global step.

A trainable mask ``{key: bool}`` (False: frozen) gives the JAX package's
``optax.masked(chain, mask)`` with ``set_to_zero`` on the rest
(``lifelong_nnunet_tpu/training/optimizer.py:27-40``): the clip's global
norm is taken over the trainable parameters' gradients only, and a frozen
parameter gets no decay, no momentum buffer and no update, so it stays bit
for bit as it was.
"""

from __future__ import annotations

import copy

import torch


def poly_lr(initial_lr: float, max_epochs: int, iters_per_epoch: int, step: int,
            exponent: float = 0.9) -> float:
    epoch = step // iters_per_epoch
    return initial_lr * (1.0 - epoch / max_epochs) ** exponent


class PolySGD:
    """Clip -> weight decay -> Nesterov SGD with the poly LR of the step
    count, over ``params``: tensors, or ``(name, tensor)`` pairs such as
    ``model.named_parameters()`` (needed with ``trainable_mask``), in a
    fixed order."""

    def __init__(self, params, max_epochs: int, iters_per_epoch: int,
                 initial_lr: float = 1e-2, momentum: float = 0.99,
                 weight_decay: float = 3e-5, clip_norm: float = 12.0,
                 trainable_mask: dict | None = None):
        items = list(params)
        named = bool(items) and isinstance(items[0], tuple)
        if trainable_mask is not None and not named:
            raise ValueError("a trainable mask needs (name, parameter) pairs")
        self.all_params = [p for _, p in items] if named else items
        self.params = [p for n, p in items if trainable_mask.get(n, True)] \
            if trainable_mask is not None else list(self.all_params)
        self.max_epochs = max_epochs
        self.iters_per_epoch = iters_per_epoch
        self.initial_lr = initial_lr
        self.clip_norm = clip_norm
        # every parameter frozen: no update at all (torch.optim refuses an
        # empty parameter list)
        self.opt = torch.optim.SGD(self.params, lr=initial_lr, momentum=momentum,
                                   nesterov=True, weight_decay=weight_decay) \
            if self.params else None
        self.step_count = 0

    def lr(self) -> float:
        """The learning rate of the next step."""
        return poly_lr(self.initial_lr, self.max_epochs, self.iters_per_epoch,
                       self.step_count)

    def step(self) -> None:
        """One update of the trainable parameters from their ``.grad``
        (optax clips with scale = min(1, clip / norm))."""
        if self.opt is not None:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = torch.clamp(self.clip_norm / norm, max=1.0)
            torch._foreach_mul_(grads, scale)
            for group in self.opt.param_groups:
                group["lr"] = self.lr()
            self.opt.step()
        self.step_count += 1

    def zero_grad(self) -> None:
        """Drop every parameter's gradient, the frozen ones' too (the CL
        hooks read all of them)."""
        for p in self.all_params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"sgd": self.opt.state_dict() if self.opt is not None else {},
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        """Restore the momentum buffers and the step count of
        :meth:`state_dict` (the parameters and the mask as they were).  The
        buffers are copied: ``torch.optim`` would share tensors already on
        the parameters' device with ``state``."""
        if self.opt is not None:
            self.opt.load_state_dict(copy.deepcopy(state["sgd"]))
        self.step_count = int(state["step"])
