"""Halo'd block pack / unpack and the blocked conv built on them: the port
of ``lifelong_nnunet_tpu/ops/pallas/block_pack.py`` (``pack_blocks``,
``unpack_blocks``, ``plan``, ``pick_bs``, ``_conv_blocked`` and
``packed_conv_in_lrelu`` with its custom VJP).

The CUDA kernels live in ``ops/csrc/block_pack.cu``.  A tensor on the CPU
goes through the plain PyTorch versions beside them
(:func:`plain_pack_blocks`, :func:`plain_unpack_blocks`); a CUDA tensor
launches the kernel or raises.  Both are pure copies, so kernel and plain
version agree bit for bit.

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

import itertools
import math

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


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in build.DTYPES:
        raise TypeError(f"{what} kernel takes float32/bfloat16, got {t.dtype}")


def pack_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """``x [B, C, D, H, W]`` -> ``[nb, C, bs + 2, bs + 2, bs + 2]``, ``bs``
    dividing D, H and W.  One launch of the pack kernel for a CUDA tensor."""
    if x.dim() != 5 or any(s % bs for s in x.shape[2:]):
        raise ValueError(f"pack_blocks takes x [B, C, D, H, W] with bs {bs} dividing "
                         f"D, H and W, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain_pack_blocks(x, bs)
    dev = build.require_cuda(x)
    _check_dtype(x, "pack_blocks")
    nb = x.shape[0] * math.prod(_grid(x.shape[2:], bs))
    out = torch.empty((nb, x.shape[1]) + (bs + 2,) * 3, dtype=x.dtype, device=dev)
    build.load_extension().pack_blocks(x.contiguous(), out, bs)
    pack_blocks.launches += 1
    return out


pack_blocks.launches = 0


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
