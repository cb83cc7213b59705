"""Halo'd block pack / unpack and the blocked conv built on them: the port
of ``lifelong_nnunet_tpu/ops/pallas/block_pack.py`` (``pack_blocks``,
``unpack_blocks``, ``plan``, ``pick_bs``, ``_conv_blocked`` and
``packed_conv_in_lrelu`` with its custom VJP).

The CUDA kernels live in ``ops/csrc/block_pack.cu``.  A tensor on the CPU
goes through the plain PyTorch versions beside them
(:func:`plain_pack_blocks`, :func:`plain_unpack_blocks`); a CUDA tensor
launches the kernel or raises.  Both are pure copies, so kernel and plain
version agree bit for bit.

How a pack launch lies on the card is decided here, by :func:`launch_plan`,
a pure function of the shape, bs, dtype and x's address: the ``"tma"`` form
(Tensor Memory Accelerator boxes of ``sz`` z-planes of ``gw`` windows along
W, zero-filled where they leave the volume, a ring of ``stages`` boxes in
each of ``blocks`` persistent blocks) wherever the TMA rules hold, which is
every shape of the main paths, else the ``"scalar"`` form.  ``pack_blocks``
counts its launches in ``launches`` and, by form, in ``forms``.

Layout, channels-first as the rest of the port: ``pack_blocks(x [B, C, D,
H, W], bs)`` returns the ``(bs + 2)^3`` windows around each ``bs^3`` block,
``[nb, C, bs + 2, bs + 2, bs + 2]`` in row-major (b, d, h, w) block order,
zeros where a window leaves the volume.  The TPU's round8 junk rows, which
exist for Mosaic's lane rules, are gone, so the conv over the blocks is a
plain VALID conv (stride 1 or 2).  ``unpack_blocks(y [nb, C, s, s, s], B,
grid)`` scatters the blocks' VALID outputs back; ``s`` comes from y (bs,
or bs / 2 after a stride-2 conv), the grid is the input's.

:func:`packed_conv_in_lrelu` is the U-Net's blocked route: the conv of
:class:`PackedConv3d` (pack -> ``F.conv3d`` VALID -> unpack; the JAX
package leaves that conv to XLA, the port to cuDNN) and then the
InstanceNorm + LeakyReLU kernel of ``instance_norm.py``.  The conv's
backward mirrors ``_fused_bwd``: for stride 1 the data gradient is the same
blocked conv of dy with the taps flipped and Cin / Cout swapped (only when
the input needs a gradient), for stride 2 cuDNN's data gradient; the weight
gradient is cuDNN's on the unblocked input, in f32; a conv bias is unused
and gets a zero gradient, as on the fused route.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import build
from .conv3d import _dx_weight, conv3d_weight_grad
from .instance_norm import EPS, instance_norm_leaky_cf


def plan(spatial, bs: int) -> bool:
    """True when ``spatial`` (D, H, W) can be packed at block size ``bs``
    (``block_pack.py:59`` without the TPU's lane rule)."""
    return bs % 8 == 0 and all(s % bs == 0 and s >= bs for s in spatial)


def pick_bs(spatial, prefer=(32, 16, 8), batch: int = 1, min_blocks: int = 1):
    """The first block size of ``prefer`` that ``plan`` admits and that gives
    at least ``min_blocks`` blocks over the batch, or None."""
    for bs in prefer:
        if plan(spatial, bs) and batch * math.prod(s // bs for s in spatial) >= min_blocks:
            return bs
    return None


def _grid(spatial, bs: int) -> tuple:
    return tuple(s // bs for s in spatial)


def _blocks(B: int, grid):
    """(b, i, j, k) of every block, in the kernels' order."""
    return itertools.product(range(B), *(range(n) for n in grid))


def plain_pack_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Each halo'd window sliced out of the zero-padded volume, stacked."""
    S = bs + 2
    xp = F.pad(x, (1,) * 6)
    return torch.stack([xp[b, :, i * bs:i * bs + S, j * bs:j * bs + S, k * bs:k * bs + S]
                        for b, i, j, k in _blocks(x.shape[0], _grid(x.shape[2:], bs))])


def plain_unpack_blocks(y: torch.Tensor, B: int, grid) -> torch.Tensor:
    """Each block's output assigned to its place in the volume."""
    s = y.shape[2]
    out = y.new_empty((B, y.shape[1]) + tuple(n * s for n in grid))
    for n, (b, i, j, k) in enumerate(_blocks(B, grid)):
        out[b, :, i * s:(i + 1) * s, j * s:(j + 1) * s, k * s:(k + 1) * s] = y[n]
    return out


FORMS = ("tma", "scalar")
# ops/csrc/block_pack.cu: threads of a TMA-form block (a producer warp and
# kConsumerWarps consumer warps) and the alignment of its shared buffers
THREADS = 32 * (1 + 8)
ALIGN = 128
# H100: shared memory one block may opt in to, and one SM's (1 KB of it
# reserved per resident block); threads an SM holds
SMEM_BLOCK = 232448
SMEM_SM = 233472
SM_THREADS = 2048
# the layout rules, from a sweep of box widths and depths, ring depths and
# blocks an SM at the CT routes' shapes on an H100
# (tools/pack_probe.py --sweep; PERF.md): a box spans the most windows along
# W that a box row holds and takes at most BOX_BYTES of whole z-planes (in
# as few equal slabs as that allows; two planes of a row of four bf16
# windows); a block's ring of boxes at most RING_BYTES and MAX_STAGES boxes
# (which keeps at least IN_FLIGHT bytes of loads in flight at every shape
# of the main paths, as the tests check); PER_SM blocks an SM
BOX_BYTES = 20 * 1024
RING_BYTES = 80 * 1024
MAX_STAGES = 16
IN_FLIGHT = 32 * 1024
PER_SM = 1


@dataclass(frozen=True)
class PackPlan:
    """One pack launch's layout.  ``form``: one of FORMS.  The TMA form
    copies boxes ``box`` = (Wb, S, sz, 1) elements (innermost first) of
    ``box_bytes``, each holding ``gw`` windows along W, ``slabs`` of them a
    window, through a ring of ``stages`` of them in each of ``blocks``
    persistent blocks of ``smem`` bytes of shared memory, over ``items``
    (row of windows, channel, slab) items."""
    form: str
    sz: int = 0
    gw: int = 0
    slabs: int = 0
    stages: int = 0
    blocks: int = 0
    box: tuple = ()
    box_bytes: int = 0
    smem: int = 0
    items: int = 0

    def args(self) -> tuple:
        """The plan as the binding takes it: (form, sz, gw, stages, blocks),
        form 1 for TMA and 0 for scalar."""
        if self.form == "scalar":
            return (0, 1, 1, 1, 1)
        return (1, self.sz, self.gw, self.stages, self.blocks)


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _slabs_aligned(S: int, sz: int, size: int) -> bool:
    """Every slab of ``sz`` planes (and the last, shorter one) of a window
    of edge S starts and ends on 16 bytes of the output."""
    plane = S * S * size
    return plane * sz % 16 == 0 and plane * (S - (-(-S // sz) - 1) * sz) % 16 == 0


def tma_layout(bs: int, size: int, sz: int, gw: int, stages: int) -> tuple:
    """(box row elements, box bytes, shared-memory bytes of a block) of the
    TMA form for elements of ``size`` bytes at block size ``bs``, boxes of
    ``sz`` planes of ``gw`` windows and a ring of ``stages`` boxes.  A box
    row runs from 16 bytes before its first window's first block column
    (that window's halo column is the last element of those 16 bytes) to
    its last window's far halo column, rounded up to 16 bytes; the block
    holds the ring, each box at a multiple of ALIGN, two 8-byte mbarriers a
    stage and ALIGN bytes of slack to align the ring.  The kernel's own
    ``lnn_pack_tma_layout`` (``ext.pack_tma_layout``), to which a
    CUDA-marked test holds this."""
    a, S = 16 // size, bs + 2
    row = _round_up(a - 1 + gw * bs + 2, a)
    box = row * S * sz * size
    return row, box, stages * _round_up(box, ALIGN) + 16 * stages + ALIGN


def tma_rules(x_shape, bs: int, dtype: torch.dtype, aligned: bool = True) -> bool:
    """True when the TMA form can take ``x [B, C, D, H, W]`` of ``dtype``
    at block size ``bs``: x's address (``aligned``), its rows (W elements)
    and its blocks' first columns (bs elements) on 16 bytes, where a box's
    innermost start must lie; an even window edge S = bs + 2 (16-byte slabs
    of the output); no box dimension past 256; B C within an int and every
    stride under 2^40 bytes."""
    B, C, D, H, W = x_shape
    size, S = dtype.itemsize, bs + 2
    return aligned and W * size % 16 == 0 and bs * size % 16 == 0 and S % 2 == 0 \
        and tma_layout(bs, size, 1, 1, 1)[0] <= 256 and B * C < 2 ** 31 \
        and D * H * W * size < 2 ** 40


def tma_plan(x_shape, bs: int, dtype: torch.dtype, sz: int, stages: int, per_sm: int,
             sms: int = 132, gw: int = 1) -> PackPlan:
    """The TMA-form layout with boxes of ``sz`` planes of ``gw`` windows,
    ``stages`` of them a block, ``per_sm`` blocks an SM (at most what the
    SM holds)."""
    B, C, D, H, W = x_shape
    size, S = dtype.itemsize, bs + 2
    wb, box_bytes, smem = tma_layout(bs, size, sz, gw, stages)
    slabs = -(-S // sz)
    per_sm = max(1, min(per_sm, SMEM_SM // (smem + 1024), SM_THREADS // THREADS))
    items = B * C * (D // bs) * (H // bs) * (W // bs // gw) * slabs
    return PackPlan("tma", sz, gw, slabs, stages, min(items, sms * per_sm),
                    (wb, S, sz, 1), box_bytes, smem, items)


@functools.lru_cache(maxsize=1024)
def _plan(x_shape, bs: int, dtype: torch.dtype, aligned: bool, sms: int) -> PackPlan:
    if not tma_rules(x_shape, bs, dtype, aligned):
        return PackPlan("scalar")
    size, S = dtype.itemsize, bs + 2
    nw = x_shape[4] // bs
    gw = max(d for d in range(1, nw + 1)
             if nw % d == 0 and tma_layout(bs, size, 1, d, 1)[0] <= 256)
    plane = tma_layout(bs, size, 1, gw, 1)[1]     # box bytes of one z-plane
    slabs = -(-S // max(1, min(S, BOX_BYTES // plane)))
    sz = next(z for z in range(-(-S // slabs), S + 1) if _slabs_aligned(S, z, size))
    box = _round_up(plane * sz, ALIGN)
    stages = max(2, min(MAX_STAGES, RING_BYTES // box))
    while stages > 1 and tma_plan(x_shape, bs, dtype, sz, stages, 1, gw=gw).smem > SMEM_BLOCK:
        stages -= 1
    plan = tma_plan(x_shape, bs, dtype, sz, stages, PER_SM, sms=sms, gw=gw)
    return plan if plan.smem <= SMEM_BLOCK else PackPlan("scalar")


def launch_plan(x_shape, bs: int, dtype: torch.dtype, data_ptr: int = 0,
                sms: int = 132) -> PackPlan:
    """The layout of one pack launch on contiguous ``x`` of ``x_shape`` [B,
    C, D, H, W] and ``dtype`` at block size ``bs``, x at address
    ``data_ptr``, on a card of ``sms`` SMs: the TMA form wherever
    :func:`tma_rules` hold, with boxes as wide as a box row allows (the
    most windows along W, a divisor of W / bs, within 256 elements) and as
    deep as BOX_BYTES allows (whole z-planes, in equal slabs), a ring of
    them within RING_BYTES, PER_SM persistent blocks an SM; else the scalar
    form.  Cached by shape."""
    return _plan(tuple(x_shape), bs, dtype, data_ptr % 16 == 0, sms)


_sms: dict = {}


def card_sms(device: torch.device) -> int:
    """The SMs of ``device``, asked once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in build.DTYPES:
        raise TypeError(f"{what} kernel takes float32/bfloat16, got {t.dtype}")


def pack_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """``x [B, C, D, H, W]`` -> ``[nb, C, bs + 2, bs + 2, bs + 2]``, ``bs``
    dividing D, H and W.  One launch of the pack kernel for a CUDA tensor,
    in the form its launch plan gives."""
    if x.dim() != 5 or any(s % bs for s in x.shape[2:]):
        raise ValueError(f"pack_blocks takes x [B, C, D, H, W] with bs {bs} dividing "
                         f"D, H and W, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain_pack_blocks(x, bs)
    dev = build.require_cuda(x)
    _check_dtype(x, "pack_blocks")
    xc = x.contiguous()
    nb = x.shape[0] * math.prod(_grid(x.shape[2:], bs))
    out = torch.empty((nb, x.shape[1]) + (bs + 2,) * 3, dtype=x.dtype, device=dev)
    plan = launch_plan(xc.shape, bs, xc.dtype, xc.data_ptr(), card_sms(dev))
    build.load_extension().pack_blocks(xc, out, bs, *plan.args())
    pack_blocks.launches += 1
    pack_blocks.forms[plan.form] += 1
    return out


pack_blocks.launches = 0
pack_blocks.forms = dict.fromkeys(FORMS, 0)


def unpack_blocks(y: torch.Tensor, B: int, grid) -> torch.Tensor:
    """``y [B * prod(grid), C, s, s, s]`` -> ``[B, C, *(n * s for n in
    grid)]``.  One launch of the unpack kernel for a CUDA tensor."""
    grid = tuple(grid)
    if y.dim() != 5 or len(grid) != 3 or y.shape[0] != B * math.prod(grid) \
            or not y.shape[2] == y.shape[3] == y.shape[4]:
        raise ValueError(f"unpack_blocks takes y [B * prod(grid), C, s, s, s], got "
                         f"{tuple(y.shape)} for B {B}, grid {grid}")
    if y.device.type == "cpu":
        return plain_unpack_blocks(y, B, grid)
    dev = build.require_cuda(y)
    _check_dtype(y, "unpack_blocks")
    s = y.shape[2]
    out = torch.empty((B, y.shape[1]) + tuple(n * s for n in grid), dtype=y.dtype, device=dev)
    build.load_extension().unpack_blocks(y.contiguous(), out)
    unpack_blocks.launches += 1
    return out


unpack_blocks.launches = 0


def _conv_blocked(v: torch.Tensor, w: torch.Tensor, stride: int, bs: int) -> torch.Tensor:
    """pack -> VALID conv -> unpack: the 3x3x3 SAME conv of ``v [B, Cin, D,
    H, W]`` with ``w [Cout, Cin, 3, 3, 3]`` (in v's dtype) at ``stride``."""
    grid = _grid(v.shape[2:], bs)
    return unpack_blocks(F.conv3d(pack_blocks(v, bs), w, stride=stride), v.shape[0], grid)


class PackedConv3d(torch.autograd.Function):
    """The conv of ``_fused`` / ``_fused_bwd`` (``block_pack.py:285-343``) as
    an autograd Function: the forward saves x and w."""

    @staticmethod
    def forward(ctx, x, w, bias, bs, stride):
        ctx.save_for_backward(x, w)
        ctx.bs, ctx.stride, ctx.has_bias = bs, stride, bias is not None
        return _conv_blocked(x, w.to(x.dtype), stride, bs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.stride == 1:
                dx = _conv_blocked(dy, _dx_weight(w).to(x.dtype), 1, ctx.bs)
            else:
                dx = torch.ops.aten.convolution_backward(
                    dy, x, w.to(x.dtype), None, (ctx.stride,) * 3, (1, 1, 1), (1, 1, 1),
                    False, (0, 0, 0), 1, (True, False, False))[0]
        dw = conv3d_weight_grad(x, w, dy, (ctx.stride,) * 3)
        dbias = torch.zeros(w.shape[:1], dtype=w.dtype, device=w.device) \
            if ctx.has_bias else None
        return dx, dw, dbias, None, None


def _uniform_stride(strides) -> int:
    s = tuple(strides)
    if s not in ((1, 1, 1), (2, 2, 2)):
        raise ValueError(f"the blocked conv takes strides (1, 1, 1) or (2, 2, 2), got {s}")
    return s[0]


def packed_conv_in_lrelu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         offset: torch.Tensor, negative_slope: float = 0.01,
                         epsilon: float = EPS, bs: int = 32, strides=(1, 1, 1),
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3d(3^3, SAME, ``strides``) over halo'd blocks of size ``bs`` ->
    InstanceNorm -> LeakyReLU.  ``x [B, Cin, D, H, W]``, ``w [Cout, Cin, 3,
    3, 3]``, ``scale``/``offset`` [Cout]; returns ``[B, Cout, D', H', W']``
    in x's dtype.  Differentiable through
    :class:`PackedConv3d` and the InstanceNorm's Function where autograd
    records; ``bias`` (the conv's, absorbed by the InstanceNorm mean) then
    gets a zero gradient."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3) \
            or not plan(x.shape[2:], bs):
        raise ValueError(f"packed_conv_in_lrelu takes x [B, Cin, D, H, W] with bs {bs} "
                         f"dividing D, H and W and w [Cout, Cin, 3, 3, 3]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    stride = _uniform_stride(strides)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        y = PackedConv3d.apply(x, w, bias, bs, stride)
    else:
        y = _conv_blocked(x, w.to(x.dtype), stride, bs)
    return instance_norm_leaky_cf(y, scale, offset, negative_slope, epsilon)
