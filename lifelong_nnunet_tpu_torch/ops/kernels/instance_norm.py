"""Fused InstanceNorm + LeakyReLU, forward and backward: the port of
``lifelong_nnunet_tpu/ops/pallas/instance_norm.py::instance_norm_leaky``
(its ``_fwd_call`` and its custom VJP ``_in_bwd``).

The CUDA kernels live in ``ops/csrc/instance_norm.cu``.  A tensor on the CPU
goes through the plain PyTorch versions beside them
(:func:`plain_instance_norm_leaky`, :func:`plain_instance_norm_leaky_bwd`);
a CUDA tensor launches the kernel or raises.  Where autograd records the
call, :class:`InstanceNormLeaky` saves x, mean and rstd and runs the
backward kernel; otherwise only the forward runs.

How a launch lies on the card is decided here, by :func:`launch_plan`, a
pure function of (B, C, N, dtype) and the card's limits (:class:`Limits`,
queried once per device by :func:`card_limits`), and handed to the kernel:
rows of at most 512 elements take the ``"warp"`` form (one warp per row, the
row in registers); longer rows are split over a thread-block cluster of up
to 16 blocks where rows are too few for the SMs or too long for one
block's shared memory, each block staging its slice there, so the row is
read from device memory once (``"cluster"``); a slice longer than a block
keeps streams the rest twice (``"stream"``).  The forward's statistics
are then each piece's two-pass mean and centred sum of squares, merged by
Chan's formula (:func:`plain_chan_stats` repeats that order on the CPU).
The wrappers count every launch in ``launches`` and, by form, in ``forms``.

``instance_norm_leaky`` keeps the JAX layout ``x [B, N, C]``;
``instance_norm_leaky_cf`` takes channels-first ``[B, C, *spatial]``, which
is what the U-Net calls after each strided conv.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from . import build

EPS = 1e-5

FORMS = ("warp", "cluster", "stream")
# ops/csrc/instance_norm.cu: elements a lane of the warp form holds, and
# 16-byte items a thread loads per streamed chunk (forward; backward, x and
# g each)
WARP_ELEMS = 16
WARP_ROWS = 4
FWD_ITEMS, BWD_ITEMS = 4, 2
MAX_THREADS = 512
MAX_CLUSTER = 16
# the layout rules, from a sweep of cluster sizes, threads and shared memory
# at every main-path shape on an H100 (tools/in_probe.py --sweep; PERF.md):
# a block keeps at most KEEP_BYTES of its slice in shared memory (three
# blocks an SM); a row is split no finer than MIN_ITEMS items a block;
# clusters of more than 8 blocks are taken only for rows of which a block
# would keep less than half; a launch whose inputs exceed L2_BYTES is split
# until each block keeps all of its slice (the L2 would not hold a second
# read), a smaller one only until half the SMs have a block
KEEP_BYTES = 64 * 1024
MIN_ITEMS = 256
L2_BYTES = 40e6


@dataclass(frozen=True)
class Limits:
    """What a launch plan is made within: the card's SMs, the dynamic shared
    memory one cluster-form block may take, and the largest cluster size
    the card schedules with that much in each block."""
    sms: int = 132
    smem: int = 232448 - 1024
    cluster: int = MAX_CLUSTER


H100 = Limits()


@dataclass(frozen=True)
class LaunchPlan:
    """One launch's layout.  ``form``: one of FORMS.  A row is split over
    ``cluster`` blocks of ``threads`` threads (``warps_per_row`` warps in
    all), block r owning elements [r slice, (r + 1) slice) of it, the first
    ``keep`` of those in ``smem`` bytes of shared memory and the rest read
    in ``chunk``-element chunks (twice).  ``vec``: 16-byte items of
    ``item`` elements, else one element an item.  ``blocks``: the grid."""
    form: str
    cluster: int
    slice: int
    keep: int
    chunk: int
    threads: int
    warps_per_row: int
    vec: bool
    item: int
    smem: int
    blocks: int

    def args(self) -> tuple:
        """The plan as the binding takes it: (form, cluster, slice, keep,
        threads, vec)."""
        return (0 if self.form == "warp" else 1, self.cluster, self.slice, self.keep,
                self.threads, int(self.vec))


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, C: int, N: int, dtype: torch.dtype, backward: bool = False,
                aligned: bool = True, limits: Limits = H100) -> LaunchPlan:
    """The layout of one InstanceNorm launch on ``[B, C, N]`` of ``dtype``
    (x, and for the ``backward`` g, of that dtype): ``aligned`` says every
    pointer is 16-byte aligned.  Cached: a training step asks again for
    the same few shapes at every call."""
    size = dtype.itemsize
    vec = aligned and N * size % 16 == 0
    item = 16 // size if vec else 1
    rows = B * C
    if N <= 32 * WARP_ELEMS:
        return LaunchPlan("warp", 1, N, N, N, 32, 1, vec, item, 0, -(-rows // WARP_ROWS))
    per_item = (2 if backward else 1) * size * item     # shared bytes of one item
    items = -(-N // item)
    cap = min(limits.smem, KEEP_BYTES) // per_item     # items a block keeps

    def split(cs, most, want):
        while cs < min(most, limits.cluster) and -(-items // (2 * cs)) >= MIN_ITEMS \
                and want(cs):
            cs *= 2
        return cs

    cs = split(1, MAX_CLUSTER, lambda cs: 2 * rows * cs < limits.sms)
    if rows * N * per_item / item > L2_BYTES:
        cs = split(cs, 8, lambda cs: cap < -(-items // cs))
    cs = split(cs, MAX_CLUSTER, lambda cs: 2 * cap < -(-items // cs))
    slice_items = -(-items // cs)
    threads = MAX_THREADS if cap < slice_items else \
        min(MAX_THREADS, max(128, 1 << math.ceil(math.log2(-(-slice_items // 16)))))
    return cluster_plan(B, C, N, dtype, backward, vec, cs, threads, min(limits.smem, KEEP_BYTES))


def cluster_plan(B: int, C: int, N: int, dtype: torch.dtype, backward: bool, vec: bool,
                 cluster: int, threads: int, smem: int) -> LaunchPlan:
    """The cluster-form layout of ``[B, C, N]`` over ``cluster`` blocks of
    ``threads`` threads a row, each keeping what fits in ``smem`` bytes."""
    size = dtype.itemsize
    item = 16 // size if vec else 1
    per_item = (2 if backward else 1) * size * item
    items = -(-N // item)
    slice_items = -(-items // cluster)
    keep_items = min(slice_items, smem // per_item)
    chunk = threads * (BWD_ITEMS if backward else FWD_ITEMS) * item
    return LaunchPlan("cluster" if keep_items == slice_items else "stream", cluster,
                      slice_items * item, keep_items * item, chunk, threads,
                      cluster * threads // 32, vec, item, keep_items * per_item,
                      B * C * cluster)


_limits: dict = {}


def card_limits(device: torch.device) -> Limits:
    """The plan's limits on ``device``, asked of the card at first use
    (``lnn_instance_norm_limits``: its SMs, its opt-in shared memory less
    the kernels' own, and the largest cluster that
    ``cudaOccupancyMaxActiveClusters`` schedules with it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _limits:
        with torch.cuda.device(index):
            _limits[index] = Limits(*build.load_extension().instance_norm_limits())
    return _limits[index]


def plain_chan_stats(x: torch.Tensor, plan: LaunchPlan, eps: float = EPS):
    """(mean, rstd) [B, C] of channels-first ``x`` as the forward kernel of
    ``plan`` forms them: per row, the pieces in the kernel's order (for each
    of the cluster's slices in rank order, its kept part, then its streamed
    chunks; the warp form's row is one piece), each piece's f32 mean and
    centred sum of squares taken two-pass, merged by Chan's formula."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B * C, -1)
    N = xf.shape[1]
    n = mean = m2 = torch.zeros(B * C)
    for r in range(plan.cluster):
        s0, s1 = r * plan.slice, min(N, (r + 1) * plan.slice)
        cuts = [s0, min(s1, s0 + plan.keep)] if plan.keep else [s0]
        cuts += range(cuts[-1] + plan.chunk, s1, plan.chunk)
        for a, b in zip(cuts, cuts[1:] + [s1]):
            if b <= a:
                continue
            p = xf[:, a:b]
            pm = p.sum(dim=1) / (b - a)
            pq = ((p - pm[:, None]) ** 2).sum(dim=1)
            tot = n + (b - a)
            d = pm - mean
            mean = mean + d * ((b - a) / tot)
            m2 = m2 + (pq + d * d * (n * (b - a) / tot))
            n = tot
    return mean.reshape(B, C), torch.rsqrt(m2.reshape(B, C) / N + eps)


def _bcast(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, C] or [C] statistics broadcast against ``x [B, C, *spatial]``."""
    lead = (1, -1) if t.dim() == 1 else tuple(t.shape)
    return t.reshape(lead + (1,) * (x.dim() - 2))


def _plain_forward(x, scale, bias, alpha, eps):
    """(out, mean, rstd): two-pass f32 statistics per (b, c), as the TPU
    kernel's ``_fwd_kernel``; out in x's dtype, mean/rstd [B, C] f32."""
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes)
    xc = xf - _bcast(mean, x)
    rstd = torch.rsqrt((xc * xc).mean(dim=axes) + eps)
    y = xc * _bcast(rstd, x) * _bcast(scale.float(), x) + _bcast(bias.float(), x)
    return torch.where(y >= 0, y, alpha * y).to(x.dtype), mean, rstd


def plain_instance_norm_leaky(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, alpha: float = 0.01,
                              eps: float = EPS) -> torch.Tensor:
    """Channels-first ``x [B, C, *spatial]``: two-pass f32 statistics per
    (b, c), as the TPU kernel's ``_fwd_kernel``; result in x's dtype."""
    return _plain_forward(x, scale, bias, alpha, eps)[0]


def plain_instance_norm_leaky_bwd(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor, g: torch.Tensor,
                                  alpha: float = 0.01, dx_dtype=None):
    """``_bwd_kernel`` step by step: the LeakyReLU mask recomputed from the
    saved statistics, then the InstanceNorm backward.  ``x``, ``g``
    ``[B, C, *spatial]``; ``mean``/``rstd`` [B, C] f32.  Returns (dx in
    ``dx_dtype``, default x's; dscale [C] f32; dbias [C] f32), the two
    summed over B."""
    axes = tuple(range(2, x.dim()))
    n = float(x[0, 0].numel())
    xhat = (x.float() - _bcast(mean, x)) * _bcast(rstd, x)
    y = xhat * _bcast(scale.float(), x) + _bcast(bias.float(), x)
    gf = g.float()
    dy = torch.where(y >= 0, gf, alpha * gf)               # leaky-relu backward
    dscale = (dy * xhat).sum(dim=axes).sum(dim=0)
    dbias = dy.sum(dim=axes).sum(dim=0)
    dxhat = dy * _bcast(scale.float(), x)
    m1 = dxhat.sum(dim=axes, keepdim=True) / n
    m2 = (dxhat * xhat).sum(dim=axes, keepdim=True) / n
    dx = _bcast(rstd, x) * (dxhat - m1 - xhat * m2)
    return dx.to(dx_dtype or x.dtype), dscale, dbias


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in build.DTYPES:
        raise TypeError(f"instance_norm_leaky kernel takes float32/bfloat16, "
                        f"got {x.dtype}")
    if x.dim() < 3 or scale.shape != x.shape[1:2] or bias.shape != x.shape[1:2]:
        raise ValueError(f"x {tuple(x.shape)} needs [B, C, *spatial] with "
                         f"scale/bias [C], got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")


def _plan(x: torch.Tensor, backward: bool, *others: torch.Tensor) -> LaunchPlan:
    """The launch plan of ``x`` on its card, 16-byte access where x and
    ``others`` (the outputs, g) all start aligned to it."""
    B, C = x.shape[:2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    return launch_plan(B, C, x.numel() // (B * C), x.dtype, backward, aligned,
                       card_limits(x.device))


def _forward(x, scale, bias, alpha, eps):
    """(out, mean, rstd): the plain version for a CPU tensor, else one
    launch of the forward kernel in the form its plan gives."""
    if x.device.type == "cpu":
        return _plain_forward(x, scale, bias, alpha, eps)
    dev = build.require_cuda(x, scale, bias)
    _check(x, scale, bias)
    B, C = x.shape[:2]
    ext = build.load_extension()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    stats = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    plan = _plan(xc, False, out)
    ext.instance_norm_leaky_fwd(xc, scale.float().contiguous(),
                                bias.float().contiguous(), out, stats[0], stats[1],
                                float(alpha), float(eps), *plan.args())
    instance_norm_leaky_cf.launches += 1
    instance_norm_leaky_cf.forms[plan.form] += 1
    return out, stats[0], stats[1]


def instance_norm_leaky_bwd_cf(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               alpha: float = 0.01, dx_dtype=None):
    """The backward of :func:`instance_norm_leaky_cf` (the math of
    :func:`plain_instance_norm_leaky_bwd`): (dx, dscale, dbias).  One launch
    of the backward kernel for a CUDA tensor, in the form its plan gives,
    and the per-row dscale / dbias summed over B by a second, tiny kernel;
    ``g`` is taken in x's dtype."""
    if x.device.type == "cpu":
        return plain_instance_norm_leaky_bwd(x, scale, bias, mean, rstd, g,
                                             alpha, dx_dtype)
    dev = build.require_cuda(x, scale, bias, mean, rstd, g)
    _check(x, scale, bias)
    dt = dx_dtype or x.dtype
    if dt not in build.DTYPES:
        raise TypeError(f"instance_norm_leaky backward writes float32/bfloat16, got {dt}")
    if g.shape != x.shape or mean.shape != x.shape[:2] or rstd.shape != x.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)}, mean {tuple(mean.shape)}, rstd "
                         f"{tuple(rstd.shape)} do not fit x {tuple(x.shape)}")
    B, C = x.shape[:2]
    ext = build.load_extension()
    xc = x.contiguous()
    gc = g.to(x.dtype).contiguous()
    dx = torch.empty(xc.shape, dtype=dt, device=dev)
    # dscale, dbias and the per-row partials, in one allocation
    work = torch.empty(2 * C + 2 * B * C, dtype=torch.float32, device=dev)
    plan = _plan(xc, True, gc, dx)
    ext.instance_norm_leaky_bwd(xc, gc, scale.float().contiguous(), bias.float().contiguous(),
                                mean.float().contiguous(), rstd.float().contiguous(), dx,
                                work[:C], work[C:2 * C], work[2 * C:], float(alpha),
                                *plan.args())
    instance_norm_leaky_bwd_cf.launches += 1
    instance_norm_leaky_bwd_cf.forms[plan.form] += 1
    return dx, work[:C], work[C:2 * C]


instance_norm_leaky_bwd_cf.launches = 0
instance_norm_leaky_bwd_cf.forms = dict.fromkeys(FORMS, 0)


class InstanceNormLeaky(torch.autograd.Function):
    """``jax.custom_vjp`` of ``instance_norm_leaky`` as an autograd
    Function: the forward keeps x, mean and rstd (not the output), the
    backward recomputes the mask from them."""

    @staticmethod
    def forward(ctx, x, scale, bias, alpha, eps):
        out, mean, rstd = _forward(x, scale, bias, alpha, eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.alpha = alpha
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = instance_norm_leaky_bwd_cf(x, scale, bias, mean, rstd, g,
                                                       ctx.alpha)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def instance_norm_leaky_cf(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, alpha: float = 0.01,
                           eps: float = EPS) -> torch.Tensor:
    """LeakyReLU(IN(x) * scale + bias) for channels-first ``x [B, C, *sp]``;
    ``scale``/``bias`` [C].  Result in x's dtype and layout; differentiable
    through :class:`InstanceNormLeaky` where autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return InstanceNormLeaky.apply(x, scale, bias, alpha, eps)
    return _forward(x, scale, bias, alpha, eps)[0]


instance_norm_leaky_cf.launches = 0
instance_norm_leaky_cf.forms = dict.fromkeys(FORMS, 0)


def instance_norm_leaky(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """The JAX signature: ``x [B, N, C]``; scale/bias [C].  Returns
    LeakyReLU(IN(x) * scale + bias) in x's dtype, ``[B, N, C]``."""
    return instance_norm_leaky_cf(x.transpose(1, 2), scale, bias,
                                  alpha).transpose(1, 2)
