"""Fused InstanceNorm + LeakyReLU, forward and backward: the port of
``lifelong_nnunet_tpu/ops/pallas/instance_norm.py::instance_norm_leaky``
(its ``_fwd_call`` and its custom VJP ``_in_bwd``).

The CUDA kernels live in ``ops/csrc/instance_norm.cu``.  A tensor on the CPU
goes through the plain PyTorch versions beside them
(:func:`plain_instance_norm_leaky`, :func:`plain_instance_norm_leaky_bwd`);
a CUDA tensor launches the kernel or raises.  Where autograd records the
call, :class:`InstanceNormLeaky` saves x, mean and rstd and runs the
backward kernel; otherwise only the forward runs.

``instance_norm_leaky`` keeps the JAX layout ``x [B, N, C]``;
``instance_norm_leaky_cf`` takes channels-first ``[B, C, *spatial]``, which
is what the U-Net calls after each strided conv.
"""

from __future__ import annotations

import torch

from . import build

EPS = 1e-5


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


def _forward(x, scale, bias, alpha, eps):
    """(out, mean, rstd): the plain version for a CPU tensor, else one
    launch of the forward kernel."""
    if x.device.type == "cpu":
        return _plain_forward(x, scale, bias, alpha, eps)
    dev = build.require_cuda(x, scale, bias)
    _check(x, scale, bias)
    B, C = x.shape[:2]
    ext = build.load_extension()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    mean = torch.empty((B, C), dtype=torch.float32, device=dev)
    rstd = torch.empty((B, C), dtype=torch.float32, device=dev)
    ext.instance_norm_leaky_fwd(xc, scale.float().contiguous(),
                                bias.float().contiguous(), out, mean, rstd,
                                float(alpha), float(eps))
    instance_norm_leaky_cf.launches += 1
    return out, mean, rstd


def instance_norm_leaky_bwd_cf(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               alpha: float = 0.01, dx_dtype=None):
    """The backward of :func:`instance_norm_leaky_cf` (the math of
    :func:`plain_instance_norm_leaky_bwd`): (dx, dscale, dbias).  One launch
    of the backward kernel for a CUDA tensor; ``g`` is taken in x's dtype."""
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
    dx = torch.empty(xc.shape, dtype=dt, device=dev)
    dscale = torch.empty(C, dtype=torch.float32, device=dev)
    dbias = torch.empty(C, dtype=torch.float32, device=dev)
    partials = torch.empty(2 * B * C, dtype=torch.float32, device=dev)
    ext.instance_norm_leaky_bwd(xc, g.to(x.dtype).contiguous(), scale.float().contiguous(),
                                bias.float().contiguous(), mean.float().contiguous(),
                                rstd.float().contiguous(), dx, dscale, dbias, partials,
                                float(alpha))
    instance_norm_leaky_bwd_cf.launches += 1
    return dx, dscale, dbias


instance_norm_leaky_bwd_cf.launches = 0


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


def instance_norm_leaky(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """The JAX signature: ``x [B, N, C]``; scale/bias [C].  Returns
    LeakyReLU(IN(x) * scale + bias) in x's dtype, ``[B, N, C]``."""
    return instance_norm_leaky_cf(x.transpose(1, 2), scale, bias,
                                  alpha).transpose(1, 2)
