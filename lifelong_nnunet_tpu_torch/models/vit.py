"""Vision Transformer (3D, per-token output) in PyTorch: the port of
``lifelong_nnunet_tpu/models/vit.py``.

The same modules and parameter names as the flax tree, so
``models/convert.py`` carries a JAX ViT's parameters across:
``patch_embed_{i}`` (:class:`PatchEmbed`, or :class:`ShiftedPatchTokenization`
with SPT), ``pos_embed_{i}``, ``block{d}`` (``norm1``, ``attn.{qkv,proj}``,
``norm2``, ``fc1``, ``fc2``), ``norm``, ``head_{i}``.  Inputs are
channels-first (``[B, C, *spatial]``); the output goes back to
channels-first ``[B, out_features, *grid]``.

Numerics follow flax: every Dense and LayerNorm computes in the compute
dtype (the ViT's input dtype: bf16 on the card, f32 or f64 for the
references) with f32 parameters; a Dense rounds its product before adding
the bias; LayerNorm has eps 1e-6 and one-pass f32 statistics E[x^2] -
E[x]^2 clamped at 0; GELU is the tanh approximation; the residual stream
is f32 (the bf16 tokens plus the f32 position embedding).

Attention routes (``use_kernels=True``): without LSA and without asked-for
weights, the flash-attention kernel (``ops/kernels/attention.py``), on
every token count; otherwise the plain path of the JAX package, LSA's
temperature and diagonal mask included.  ``use_kernels=False`` is the
plain path throughout.  On the card the kernel takes the presets' head
dims (64, 80) and raises on others (the small ``vit_depth`` overrides'
2 heads of 8 or more): those train on the plain route.

Task-specific LayerNorms (``ln_tasks``, a tuple of task names): every
:class:`TaskLayerNorm` of the blocks and the final ``norm`` holds one
parameter set per task, ``ln.<task>.{weight,bias}`` (flax's ``ln_<task>``
scopes), and ``task_idx`` selects the set a forward uses, as the JAX
``TaskLayerNorm`` does.  Without ``ln_tasks`` a TaskLayerNorm keeps its
one set as ``weight`` / ``bias`` (flax's ``LayerNorm_0``).  SPT's
LayerNorm is never task-specific.

Under model parallelism the Linear layers (qkv, proj, the MLP, the heads)
and the patch embedding hold a slice of their output features and gather
it (``_dense``); the LayerNorms, the attention and the position
embeddings run on the full, replicated activations.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.attention import flash_attention, plain_attention
from ..parallel.collectives import sharded_call

VIT_SIZES = {
    "base": {"embed_dim": 768, "depth": 12, "num_heads": 12},
    "large": {"embed_dim": 1024, "depth": 24, "num_heads": 16},
    "huge": {"embed_dim": 1280, "depth": 32, "num_heads": 16},
}
LN_EPS = 1e-6
_TRUNC = 0.87962566103423978   # std of a unit normal truncated at +-2


def patch_dim_for(img_size: Sequence[int], max_patch: int = 16) -> tuple:
    """Per-axis patch size: the largest common divisor of all spatial dims
    that is <= ``max_patch``, the same on every axis."""
    common = None
    for s in img_size:
        ds = {d for d in range(1, int(s) + 1) if int(s) % d == 0}
        common = ds if common is None else common & ds
    valid = [d for d in sorted(common) if d <= max_patch]
    p = valid[-1] if valid else 1
    return tuple(p for _ in img_size)


def vit_kwargs_for_type(vit_type: str) -> dict:
    if vit_type not in VIT_SIZES:
        raise KeyError(f"unknown ViT type {vit_type!r}; options {sorted(VIT_SIZES)}")
    return dict(VIT_SIZES[vit_type])


def _trunc_normal_(w: torch.Tensor, scale: float, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    ``lecun_normal`` is scale 1, ``he_normal`` scale 2."""
    std = math.sqrt(scale / fan_in) / _TRUNC
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: the product in ``dtype``, then the bias
    (on the layer's slice of the output features, gathered, when model
    parallelism shards it)."""
    return sharded_call(lin, x, lambda h: F.linear(h.to(dtype), lin.weight.to(dtype))
                        + lin.bias.to(dtype), -1)


def _linear(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    """A Dense layer with flax's initializers: lecun_normal, zero bias."""
    lin = nn.Linear(cin, cout)
    _trunc_normal_(lin.weight, 1.0, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)`` over the last axis: one-pass f32 (f64
    for an f64 input) statistics, the normalization in that precision, the
    result in ``dtype``."""
    xf = x if x.dtype == torch.float64 else x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
    return ((xf - mean) * (torch.rsqrt(var + eps) * weight) + bias).to(dtype)


class TaskLayerNorm(nn.Module):
    """LayerNorm with one parameter set (flax's ``TaskLayerNorm`` without
    ``ln_tasks``: its ``LayerNorm_0``) or, with ``ln_tasks``, one set per
    task in the ModuleDict ``ln``; ``task_idx`` picks the task's set."""

    def __init__(self, dim: int, ln_tasks: Sequence[str] = ()):
        super().__init__()
        self.ln_tasks = tuple(ln_tasks)
        if self.ln_tasks:
            self.ln = nn.ModuleDict({t: TaskLayerNorm(dim) for t in self.ln_tasks})
        else:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, task_idx: int = 0) -> torch.Tensor:
        if self.ln_tasks:
            return self.ln[self.ln_tasks[task_idx]](x, dtype)
        return layer_norm(x, self.weight, self.bias, dtype)


class PatchEmbed(nn.Module):
    """Patch embedding: the stride = kernel conv as the JAX package computes
    it, a gather of each patch into one row and a product with the kernel.
    ``proj`` holds the conv's ``[E, C, *patch]`` weight; rows are
    flattened in that (C, *patch) order, tokens in the grid's row-major
    order, as ``F.conv3d(x, weight, stride=patch)`` orders them."""

    def __init__(self, in_channels: int, patch_size: Sequence[int], embed_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.patch_size = tuple(patch_size)
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[len(self.patch_size)]
        self.proj = conv(in_channels, embed_dim, self.patch_size, self.patch_size)
        _trunc_normal_(self.proj.weight, 2.0, self.proj.weight[0].numel(), generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        """``x [B, C, *spatial]`` -> (tokens ``[B, N, E]`` in ``dtype``, grid)."""
        B, C = x.shape[:2]
        p = self.patch_size
        grid = tuple(s // q for s, q in zip(x.shape[2:], p))
        dim = len(p)
        # [B, C, g0, p0, g1, p1, ...] -> [B, g0, g1, ..., C, p0, p1, ...]
        xr = x.reshape((B, C) + tuple(v for a in range(dim) for v in (grid[a], p[a])))
        perm = ((0,) + tuple(2 + 2 * a for a in range(dim)) + (1,)
                + tuple(3 + 2 * a for a in range(dim)))
        xt = xr.permute(perm).reshape(B, math.prod(grid), -1).to(dtype)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1).to(dtype)
        return sharded_call(self.proj, xt, lambda h: F.linear(h, w)
                            + self.proj.bias.to(dtype), -1), grid


class ShiftedPatchTokenization(nn.Module):
    """SPT: the input and 4 copies shifted diagonally by half a patch in the
    two trailing spatial axes, concatenated on channels, LayerNorm over
    channels, then patch embedding (``embed``)."""

    def __init__(self, in_channels: int, patch_size: Sequence[int], embed_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.norm = TaskLayerNorm(5 * in_channels)
        self.embed = PatchEmbed(5 * in_channels, patch_size, embed_dim, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        sh = max(1, self.patch_size[-2] // 2)
        sw = max(1, self.patch_size[-1] // 2)
        dims = (x.dim() - 2, x.dim() - 1)
        shifted = [x] + [torch.roll(x, (dh * sh, dw * sw), dims=dims)
                         for dh, dw in ((-1, -1), (-1, 1), (1, -1), (1, 1))]
        x = self.norm(torch.cat(shifted, dim=1).movedim(1, -1), dtype).movedim(-1, 1)
        return self.embed(x, dtype)


class Attention(nn.Module):
    """Multi-head self-attention over ``[B, N, D]`` tokens.  The fused qkv
    projection is laid out ``(3, H, hd)`` per token, as flax's; q, k and v
    are made contiguous ``[B, H, N, hd]`` once, for either route."""

    def __init__(self, dim: int, num_heads: int, lsa: bool, use_kernels: bool,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.lsa = lsa
        self.use_kernels = use_kernels
        self.qkv = _linear(dim, 3 * dim, generator)
        self.proj = _linear(dim, dim, generator)
        if lsa:
            # learnable per-head temperature, initialized to hd**-0.5
            self.temperature = nn.Parameter(
                torch.full((num_heads, 1, 1), (dim // num_heads) ** -0.5))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, need_weights: bool = False):
        B, N, D = x.shape
        hd = D // self.num_heads
        qkv = _dense(self.qkv, x, dtype).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if self.use_kernels and not self.lsa and not need_weights:
            out, weights = flash_attention(q, k, v), None
        else:
            scale = self.temperature if self.lsa else hd ** -0.5
            out, weights = plain_attention(q, k, v, scale, mask_diagonal=self.lsa)
        out = out.transpose(1, 2).reshape(B, N, D)
        return _dense(self.proj, out, dtype), weights


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)), then + MLP(norm2(x))
    with a tanh-GELU; x stays in its (f32) dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, lsa: bool,
                 use_kernels: bool, generator: torch.Generator, ln_tasks: Sequence[str] = ()):
        super().__init__()
        self.norm1 = TaskLayerNorm(dim, ln_tasks)
        self.attn = Attention(dim, num_heads, lsa, use_kernels, generator)
        self.norm2 = TaskLayerNorm(dim, ln_tasks)
        self.fc1 = _linear(dim, mlp_ratio * dim, generator)
        self.fc2 = _linear(mlp_ratio * dim, dim, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, need_weights: bool = False,
                task_idx: int = 0):
        a, weights = self.attn(self.norm1(x, dtype, task_idx), dtype, need_weights)
        x = x + a
        h = F.gelu(_dense(self.fc1, self.norm2(x, dtype, task_idx), dtype), approximate="tanh")
        return x + _dense(self.fc2, h, dtype), weights


class VisionTransformer(nn.Module):
    """Dense (per-token) ViT over one or more input stages.

    ``in_shapes``: ``(C, *spatial)`` of each stage's input (the position
    embeddings are sized from it, as flax sizes them at init);
    ``out_features``: the output channels of each stage (one stage for
    V1-V3, one per decoder stage for V4, sharing the blocks); ``ln_tasks``:
    the task-specific LayerNorms' tasks (module docstring).  Call with
    ``idx`` selecting the stage and ``task_idx`` the LayerNorms' task;
    returns ``[B, out_features[idx], *grid]``
    in f32 (f64 for an f64 input), plus the per-block attention weights
    with ``return_attn``."""

    def __init__(self, in_shapes, out_features, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4, lsa: bool = False,
                 spt: bool = False, max_patch: int = 16, use_kernels: bool = True,
                 generator: torch.Generator | None = None, ln_tasks: Sequence[str] = ()):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.depth = depth
        embed = ShiftedPatchTokenization if spt else PatchEmbed
        for i, shape in enumerate(in_shapes):
            patch = patch_dim_for(shape[1:], max_patch)
            n_tokens = math.prod(s // p for s, p in zip(shape[1:], patch))
            self.add_module(f"patch_embed_{i}", embed(shape[0], patch, embed_dim, gen))
            pos = torch.empty(1, n_tokens, embed_dim)
            with torch.no_grad():
                pos.normal_(0.0, 0.02, generator=gen)
            self.register_parameter(f"pos_embed_{i}", nn.Parameter(pos))
        for d in range(depth):
            self.add_module(f"block{d}", Block(embed_dim, num_heads, mlp_ratio, lsa,
                                               use_kernels, gen, ln_tasks))
        self.norm = TaskLayerNorm(embed_dim, ln_tasks)
        for i, out in enumerate(out_features):
            self.add_module(f"head_{i}", _linear(embed_dim, out, gen))

    def forward(self, x: torch.Tensor, idx: int = 0, return_attn: bool = False,
                task_idx: int = 0):
        dtype = x.dtype
        tokens, grid = getattr(self, f"patch_embed_{idx}")(x, dtype)
        h = tokens + getattr(self, f"pos_embed_{idx}")
        attns = []
        for d in range(self.depth):
            h, w = getattr(self, f"block{d}")(h, dtype, return_attn, task_idx)
            attns.append(w)
        head = getattr(self, f"head_{idx}")
        out = _dense(head, self.norm(h, dtype, task_idx), dtype)
        out = out.reshape((x.shape[0],) + grid + (head.out_features,)).movedim(-1, 1)
        out = out if out.dtype == torch.float64 else out.float()
        return (out, attns) if return_attn else out
