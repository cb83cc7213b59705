"""2x up-interleave, its inverse, and the k=s=2 transposed conv built on
them: the port of ``lifelong_nnunet_tpu/ops/pallas/interleave.py``
(``interleave_up2``, ``deinterleave2``, ``phase_split_dh``,
``conv_transpose3d_matmul_pallas``) and of the upsample gate
``lifelong_nnunet_tpu/ops/conv25d.py::upsample_eligible``.

The CUDA kernels live in ``ops/csrc/interleave.cu``.  A tensor on the CPU
goes through the plain PyTorch versions beside them
(:func:`plain_interleave`, :func:`plain_deinterleave`); a CUDA tensor
launches the kernel or raises.  Both are pure copies, so kernel and plain
version agree bit for bit.

``interleave_up2`` and ``deinterleave2`` keep the JAX contract, four
``(ND, H, M)`` arrays <-> ``(ND, 2, 2H, M)`` with ``out[nd, i, 2h + j] =
a_ij[nd, h]``; each is an autograd Function whose backward is the other
kernel.  The JAX gate's ``M % 128`` lane rule is dropped.

:func:`conv_transpose3d_interleave` is the decoder's upsample on this
route.  The port is channels-first, where W does not merge into the row
for free as it does channels-last on the TPU (``interleave.py:175-184``),
so the kernels take a second form, K = 2, that also interleaves W: the
eight octant products ``[N, Co, D, H, W]`` (one ``torch.bmm`` of the
weights' ``[8 Co, Ci]`` rows with x) become ``[N, Co, 2D, 2H, 2W]`` in one
launch, already in the layout the decoder's concat and convs take.  Its
backward is the K = 2 de-interleave into the stacked octants, then the
products' adjoints.
"""

from __future__ import annotations

import math

import torch

from . import build


def upsample_eligible(x_shape, kernel, stride) -> bool:
    """The JAX gate of the large-volume upsample routes (``conv25d.py:391``)
    for a channels-first ``x_shape [N, C, D, H, W]``: 3D, kernel equal to
    stride, at least 2^18 output voxels per item and N * D >= 32."""
    if len(x_shape) != 5 or len(kernel) != 3 or tuple(kernel) != tuple(stride):
        return False
    d, h, w = x_shape[2:]
    return d * h * w * math.prod(stride) >= (1 << 18) and x_shape[0] * d >= 32


def plain_interleave(parts) -> torch.Tensor:
    """4 K arrays ``[N, R, H, Wm]`` (K = 1 or 2) -> ``[N, R, 2, 2H, K Wm]``,
    ``out[n, r, i, 2h + j, K w + k] = parts[(2 i + j) K + k][n, r, h, w]``."""
    K = len(parts) // 4
    N, R, H, Wm = parts[0].shape
    s = torch.stack(list(parts), dim=2).view(N, R, 2, 2, K, H, Wm)
    return s.permute(0, 1, 2, 5, 3, 6, 4).reshape(N, R, 2, 2 * H, K * Wm)


def plain_deinterleave(x: torch.Tensor, K: int) -> list:
    """The inverse of :func:`plain_interleave`: ``[N, R, 2, 2H, K Wm]`` -> 4 K
    arrays ``[N, R, H, Wm]``."""
    N, R, _, H2, KW = x.shape
    v = x.reshape(N, R, 2, H2 // 2, 2, KW // K, K).permute(0, 1, 2, 4, 6, 3, 5)
    return [v[:, :, i, j, k].contiguous() for i in range(2) for j in range(2)
            for k in range(K)]


def _check(t: torch.Tensor) -> None:
    if t.dtype not in build.DTYPES:
        raise TypeError(f"the interleave kernels take float32/bfloat16, got {t.dtype}")


def _interleave(parts) -> torch.Tensor:
    """One launch of the interleave kernel for CUDA tensors: ``parts``, 4 K
    arrays ``[N, R, H, Wm]`` of one shape and strides, contiguous after
    their batch dim."""
    if parts[0].device.type == "cpu":
        return plain_interleave(parts)
    dev = build.require_cuda(*parts)
    _check(parts[0])
    K = len(parts) // 4
    N, R, H, Wm = parts[0].shape
    out = torch.empty((N, R, 2, 2 * H, K * Wm), dtype=parts[0].dtype, device=dev)
    build.load_extension().interleave_up2(list(parts), out)
    interleave_up2.launches += 1
    return out


def _deinterleave(x: torch.Tensor, K: int) -> torch.Tensor:
    """One launch of the de-interleave kernel for a CUDA tensor: ``x [N, R,
    2, 2H, K Wm]`` -> the 4 K arrays stacked, ``[N, 4 K, R, H, Wm]``."""
    N, R, _, H2, KW = x.shape
    if x.device.type == "cpu":
        return torch.stack(plain_deinterleave(x, K), dim=1)
    build.require_cuda(x)
    _check(x)
    xc = x.contiguous()
    if xc.data_ptr() % (2 * xc.element_size()):
        xc = xc.clone()                      # the K = 2 pair loads are aligned
    out = torch.empty((N, 4 * K, R, H2 // 2, KW // K), dtype=x.dtype, device=x.device)
    build.load_extension().deinterleave2(xc, list(out.unbind(1)))
    deinterleave2.launches += 1
    return out


def _as_parts(a00, a01, a10, a11) -> list:
    return [a.contiguous()[None] for a in (a00, a01, a10, a11)]


class Interleave(torch.autograd.Function):
    """``interleave_up2``'s ``jax.custom_vjp``: the backward de-interleaves."""

    @staticmethod
    def forward(ctx, a00, a01, a10, a11):
        return _interleave(_as_parts(a00, a01, a10, a11))[0]

    @staticmethod
    def backward(ctx, g):
        return tuple(_deinterleave(g[None], 1)[0])


class Deinterleave(torch.autograd.Function):
    """``deinterleave2``'s ``jax.custom_vjp``: the backward interleaves."""

    @staticmethod
    def forward(ctx, x):
        return tuple(_deinterleave(x[None], 1)[0])

    @staticmethod
    def backward(ctx, *gs):
        # an unused output's gradient arrives as zeros (materialized grads)
        return _interleave(_as_parts(*gs))[0]


def interleave_up2(a00, a01, a10, a11) -> torch.Tensor:
    """``out[nd, i, 2h + j, :] = a_ij[nd, h, :]``: four ``(ND, H, M)`` arrays
    -> ``(ND, 2, 2H, M)``.  Differentiable."""
    parts = (a00, a01, a10, a11)
    if any(a.shape != a00.shape or a.dim() != 3 for a in parts):
        raise ValueError(f"interleave_up2 takes four (ND, H, M) arrays of one shape, got "
                         f"{[tuple(a.shape) for a in parts]}")
    return Interleave.apply(*parts)


interleave_up2.launches = 0


def deinterleave2(x: torch.Tensor) -> tuple:
    """The inverse of :func:`interleave_up2`: ``x (ND, 2, 2H, M)`` -> four
    ``(ND, H, M)`` arrays, ``a_ij[nd, h] = x[nd, i, 2h + j]``.
    Differentiable."""
    if x.dim() != 4 or x.shape[1] != 2 or x.shape[2] % 2:
        raise ValueError(f"deinterleave2 takes x (ND, 2, 2H, M), got {tuple(x.shape)}")
    return Deinterleave.apply(x)


deinterleave2.launches = 0


def phase_split_dh(x: torch.Tensor) -> tuple:
    """The four (D-parity, H-parity) phase fields of a channels-last volume
    ``x [N, D, H, W, C]``: ``a_ij[n, d, h] = x[n, 2d + i, 2h + j]``, each
    ``[N, D/2, H/2, W, C]``.  D and H even; differentiable."""
    N, D, H, W, C = x.shape
    if D % 2 or H % 2:
        raise ValueError(f"phase_split_dh needs even D and H, got {tuple(x.shape)}")
    parts = deinterleave2(x.reshape(N * (D // 2), 2, H, W * C))
    return tuple(p.reshape(N, D // 2, H // 2, W, C) for p in parts)


class _OctantInterleave(torch.autograd.Function):
    """The stacked octant products ``[N, 8, R, H, W]`` -> ``[N, R, 2, 2H,
    2W]`` (the K = 2 interleave); the backward de-interleaves into the
    stack."""

    @staticmethod
    def forward(ctx, y):
        return _interleave(y.unbind(1))

    @staticmethod
    def backward(ctx, g):
        return _deinterleave(g, 2)


def conv_transpose3d_interleave(x: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv_transpose3d(x, w, bias, stride=2)`` for ``x [N, Ci, D, H,
    W]``, ``w [Ci, Co, 2, 2, 2]`` (``nn.ConvTranspose3d``'s layout), in x's
    dtype: the eight octant products ``out[:, :, 2d + i, 2h + j, 2w + k] =
    w[:, :, i, j, k]^T x`` in one batched product, then the interleave
    kernel.  Exact up to the products' summation order (the taps do not
    overlap); differentiable."""
    N, Ci, D, H, W = x.shape
    if w.dim() != 5 or w.shape[0] != Ci or tuple(w.shape[2:]) != (2, 2, 2):
        raise ValueError(f"conv_transpose3d_interleave takes x [N, Ci, D, H, W] and w "
                         f"[Ci, Co, 2, 2, 2], got {tuple(x.shape)}, {tuple(w.shape)}")
    Co = w.shape[1]
    # rows ((i, j, k), co), the octant index 4 i + 2 j + k
    w8 = w.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(8 * Co, Ci)
    y = torch.bmm(w8.expand(N, -1, -1), x.reshape(N, Ci, D * H * W))
    out = _OctantInterleave.apply(y.view(N, 8, Co * D, H, W)).view(N, Co, 2 * D, 2 * H, 2 * W)
    return out if bias is None else out + bias.to(out.dtype).view(1, -1, 1, 1, 1)
