"""Non-causal softmax attention, forward and backward: the port of
``lifelong_nnunet_tpu/models/vit.py::_flash_attention`` (jax's bundled
Pallas TPU flash attention, forward and custom VJP).

The CUDA kernels live in ``ops/csrc/flash_attention.cu``.  A tensor on the
CPU goes through the plain PyTorch versions beside them; a CUDA tensor
launches the kernels or raises, whatever its token count (the JAX package
routed to its kernel only on a TPU, in bf16, at >= 512 tokens divisible by
256; the port takes every attention the ViT asks of it).  The input dtype
chooses the kernels: bf16 (the ViT's routes) runs the tensor-core kernels
(``wgmma``; counted on ``tc_launches`` beside ``launches``), f32 the f32 FMA
kernels, so an f32 attention is not rounded to bf16 or TF32.

``q, k, v [B, H, N, hd]``, ``hd`` 64 or 80 on the card, scale ``hd**-0.5``.
The kernels take contiguous tensors (the ViT's ``Attention`` makes q, k and
v contiguous once, from its fused qkv projection) and return
``softmax(q k^T * scale) v`` in q's dtype.  :class:`FlashAttention` keeps
the output and the f32 row log-sum-exp for the backward, which recomputes
the weights from them (FlashAttention-2): the ``[B, H, N, N]`` weights are
never kept.

Numerics against :func:`plain_attention` (the JAX einsum path): both take
f32 logits and an f32 softmax; the plain version rounds the normalized
weights to the activation dtype before the product with v.  The FMA kernels
keep their unnormalized weights in f32 and divide once at the end; the
tensor-core kernels round the unnormalized weights (and, in the backward,
dS) to bf16 as operands of their products, with f32 sums.  On the card
(``chip_smoke.py``, phase 7) the kernels are held to the plain versions on
the same inputs within atol 1e-5 + rtol 1e-4 in f32 and atol 2e-3 + rtol
1e-2 in bf16 (a bf16 rounding of the output, or of the weights), forward
and backward.
"""

from __future__ import annotations

import torch

from . import build

HEAD_DIMS = (64, 80)     # the head dims of the ViT presets (base/large, huge)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """f32 for the logits and statistics, f64 kept (the f64 reference)."""
    return t if t.dtype == torch.float64 else t.float()


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale=None,
                    mask_diagonal: bool = False):
    """The JAX einsum path (``vit.py:212-226``): f32 logits times ``scale``
    (default ``hd**-0.5``; LSA passes its per-head temperature ``[H, 1,
    1]``), the diagonal at -1e9 with ``mask_diagonal`` (LSA), an f32
    softmax, the weights cast to q's dtype and applied to v.  Returns (out
    ``[B, H, N, hd]`` in q's dtype, weights ``[B, H, N, N]`` f32)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bhnd,bhmd->bhnm", _acc(q), _acc(k)) * scale
    if mask_diagonal:
        n = q.shape[2]
        logits = logits.masked_fill(torch.eye(n, dtype=torch.bool, device=q.device), -1e9)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", weights.to(q.dtype), v), weights


def plain_attention_fwd(q, k, v, scale=None):
    """The forward kernel's plain version: (out, lse), ``lse`` the f32 row
    log-sum-exp of the scaled logits that the backward recomputes the
    weights from; the weights cast to q's dtype before the product with v,
    as in :func:`plain_attention`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bhnd,bhmd->bhnm", _acc(q), _acc(k)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - lse[..., None])
    return torch.einsum("bhnm,bhmd->bhnd", weights.to(q.dtype), v), lse


def plain_attention_bwd(q, k, v, out, lse, dout, scale=None):
    """FlashAttention-2's backward, step by step: the weights recomputed from
    ``lse``, D = rowsum(dout * out), dS = P * (dout v^T - D).  Returns (dq,
    dk, dv) in q's dtype, computed in f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf, of, gf = (_acc(t) for t in (q, k, v, out, dout))
    p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhnm,bhnd->bhmd", p, gf)
    dp = torch.einsum("bhnd,bhmd->bhnm", gf, vf)
    ds = p * (dp - (gf * of).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    if q.dtype not in build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash-attention kernel takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes q, k, v [B, H, N, hd] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes head dim {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")


def flash_attention_fwd(q, k, v, scale=None):
    """The forward of :func:`flash_attention` with its row log-sum-exp:
    (out in q's dtype, lse ``[B, H, N]`` f32).  A CPU tensor takes
    :func:`plain_attention_fwd`; a CUDA tensor launches the forward kernel
    (counted on ``flash_attention.launches``; bf16 on the tensor cores,
    counted on ``flash_attention.tc_launches`` too) or raises."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_attention_fwd(q, k, v, scale)
    dev = build.require_cuda(q, k, v)
    _check(q, k, v)
    ext = build.load_extension()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    tc = q.dtype == torch.bfloat16
    (ext.flash_attention_tc_fwd if tc else ext.flash_attention_fwd)(q, k, v, out, lse,
                                                                     float(scale))
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, scale=None):
    """The backward of :func:`flash_attention` (the math of
    :func:`plain_attention_bwd`): (dq, dk, dv) in q's dtype.  For a CUDA
    tensor one call launches the three backward kernels (D, dK/dV, dQ), on
    the tensor cores for bf16 (counted as the forward is); ``dout`` is
    taken in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, out, lse, dout, scale)
    dev = build.require_cuda(q, k, v, out, lse, dout)
    _check(q, k, v)
    ext = build.load_extension()
    q, k, v, out = (t.contiguous() for t in (q, k, v, out))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    tc = q.dtype == torch.bfloat16
    (ext.flash_attention_tc_bwd if tc else ext.flash_attention_bwd)(
        q, k, v, out, dout.to(q.dtype).contiguous(), lse.float().contiguous(), delta, dq, dk,
        dv, float(scale))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += tc
    return dq, dk, dv


flash_attention_bwd.launches = flash_attention_bwd.tc_launches = 0


class FlashAttention(torch.autograd.Function):
    """The custom VJP of jax's flash attention as an autograd Function: the
    forward saves q, k, v, the output and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_bwd(*ctx.saved_tensors, g, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * hd**-0.5) v, non-causal, for ``q, k, v [B, H, N,
    hd]``; the result in q's dtype.  Differentiable through
    :class:`FlashAttention` where autograd records."""
    scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


flash_attention.launches = flash_attention.tc_launches = 0
