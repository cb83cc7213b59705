"""The collectives of data- and model-parallel training, over
``torch.distributed`` process groups.

Data axis (:class:`DataGroup`).  Every rank of a data group holds equal,
contiguous rows of the global batch.  A loss that reduces over the batch
reduces its partial sums with :meth:`DataGroup.sum`, an all-reduce whose
backward is the identity: each rank then holds the global-batch loss, and
its gradient is that rank's share of the global gradient, so the sum of
the ranks' gradients (:meth:`DataGroup.all_reduce_grads`, one coalesced
all-reduce a step, which is what GSPMD inserts) is the gradient of the
global-batch loss.  A term of the parameters alone (EWC's and RW's
penalties) is added after that sum, once.

Model axis (:class:`ModelShard`).  A sharded Conv, ConvTranspose or Linear
holds a slice of its output features.  Its input passes through
:meth:`ModelShard.enter` (identity forward; the backward sums the input's
gradient over the model group, since each rank's slice contributes part
of it) and its output through :meth:`ModelShard.gather` (an all-gather
along the feature dim; the backward takes the rank's own slice of the
gradient, with no collective: downstream of the gather every rank computes
the same activations, so a summing backward would give M times the
gradient).

gloo has no bfloat16 collectives on every build, so a bfloat16 tensor is
reduced or gathered in float32 and cast back (a gather is exact either
way).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``."""
    w = _wire(t)
    dist.all_reduce(w, group=group)
    if w is not t:
        t.copy_(w)
    return t


def all_gather_cat(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    w = _wire(t.contiguous())
    parts = [torch.empty_like(w) for _ in range(size)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class DataGroup:
    """The data axis of one rank: ``size`` ranks, this one ``index``."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, with an identity backward."""
        return _SumOverGroup.apply(x, self.group)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum of a tensor outside autograd (counts, histograms)."""
        return all_reduce_(x, self.group)

    def all_reduce_grads(self, tensors: list) -> None:
        """Sum the ``.grad`` of every tensor that has one over the data
        group, in one coalesced all-reduce per dtype and device."""
        grads = [t.grad for t in tensors if t.grad is not None]
        self.sum_flat_(grads)

    def sum_flat_(self, tensors: list) -> None:
        """In-place sums of a list of tensors, coalesced per dtype and device."""
        by_kind: dict = {}
        for g in tensors:
            by_kind.setdefault((g.dtype, g.device), []).append(g)
        for gs in by_kind.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            all_reduce_(flat, self.group)
            torch._foreach_copy_(gs, [f.view_as(g) for f, g in
                                      zip(flat.split([g.numel() for g in gs]), gs)])


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.shard.group), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return all_gather_cat(y, shard.group, shard.size, dim)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.chunk(s.size, dim=ctx.dim)[s.index].contiguous(), None, None


class ModelShard:
    """The model axis of one rank: ``size`` ranks, this one ``index``; set as
    ``module.mp`` on every sharded module (``mesh.shard_model``)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterModel.apply(x, self)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherModel.apply(y, self, dim)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x, self.group)


def sharded_call(module, x: torch.Tensor, compute, dim: int) -> torch.Tensor:
    """``compute(x)`` for a module whose output features (along ``dim``) may
    be sharded over the model axis: on its slice, then gathered."""
    shard = getattr(module, "mp", None)
    if shard is None:
        return compute(x)
    return shard.gather(compute(shard.enter(x)), dim)
