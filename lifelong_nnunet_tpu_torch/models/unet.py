"""Plans-driven generic U-Net in PyTorch: the port of
``lifelong_nnunet_tpu/models/unet.py``.

Same topology and the same top-level submodule names in the same
(topological) order, so the multi-head split can cut at any of them:
``enc{s}``, ``bottleneck``, then ``up{d}``/``dec{d}`` pairs, then ``seg{d}``;
stages hold ``block0`` (maybe strided) and ``block1``.  Tensors are
channels-first (``[B, C, *spatial]``), PyTorch's layout.  Parameters stay
float32; activations run in ``dtype`` (see ``device.compute_dtype``).

ConvNormAct routes (``use_kernels=True``), in this order:

* with ``blocked_conv``, a 3x3x3 conv of stride 1 or 2 that the JAX gate
  ``_packed_bs`` admits (``lifelong_nnunet_tpu/models/unet.py:248-276``:
  max(Cin, Cout) <= 64, a cubic block of 32 or 16 dividing every spatial
  axis, at least 16 blocks over the batch) -> the blocked conv of
  ``ops/kernels/block_pack.py`` (pack -> cuDNN VALID conv -> unpack), then
  the InstanceNorm + LeakyReLU kernel.  That gate fires at CT scale (a
  128^3 patch), not at hippocampus scale;
* 3x3x3 stride-1 conv -> the fused conv + InstanceNorm + LeakyReLU kernel
  (``ops/kernels/conv3d.py``).  Unlike the JAX package, whose TPU kernel
  only takes lane-aligned widths, every such conv takes it.  The conv bias
  is ignored there (the InstanceNorm mean absorbs it), as on the TPU, and
  gets a zero gradient, so the optimizer treats it as optax does.
* any other conv (strided, anisotropic, 2D) -> ``F.conv{2,3}d`` with
  symmetric ``k//2`` padding, then the InstanceNorm + LeakyReLU kernel
  (``ops/kernels/instance_norm.py``).

With ``upsample="interleave"``, each 3D (2, 2, 2) transposed conv that the
JAX gate ``upsample_eligible`` admits (>= 2^18 output voxels per item, N * D
>= 32) runs as octant products plus the interleave kernel
(``ops/kernels/interleave.py``); every other level stays on
``F.conv_transpose3d``.  The JAX package reads the two switches behind
these routes (``LNN_BLOCKED_CONV=1``, ``LNN_UPT_MODE=pallas``) where it
builds its model; the port reads them there too (``training/trainer.py``,
``training/restore.py``) and passes them in as arguments.  The parameters
are the same on every route.

With ``remat``, every stage (encoder, bottleneck, decoder, as the JAX
model's ``stage_cls = nn.remat(ConvStage)``) runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` where
autograd records: its activations are not kept for the backward but
recomputed there, so each forward kernel of a stage launches twice per
train step; the kernels' ``autograd.Function``s run unchanged inside the
recompute.  A decoder stage's recompute includes the concatenation of
its input with the skip, as JAX's stage does it inside.

Every route is differentiable: where autograd records, the kernels'
``autograd.Function``s run their backward kernels (the data gradient of a
fused or stride-1 blocked conv only when its input needs one).  On the CPU
every kernel's wrapper runs its plain PyTorch version.
``use_kernels=False`` is the plain route: the JAX package's XLA
composition (conv with bias, :class:`InstanceNorm`, LeakyReLU, the direct
transposed conv), kept to measure the kernels against; it ignores both
switches.

Under model parallelism (``parallel/mesh.py:shard_model``) a block, a
transposed conv or a head whose output features the rule shards holds its
slice of them (``module.mp``): it runs its route on that slice (the fused
kernel, the InstanceNorm kernel and the blocked route take any channel
count; the InstanceNorm is per channel) and all-gathers the channels
(``parallel/collectives.py:sharded_call``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.block_pack import packed_conv_in_lrelu, pick_bs
from ..ops.kernels.conv3d import conv3d_in_lrelu_cf
from ..ops.kernels.instance_norm import instance_norm_leaky_cf
from ..ops.kernels.interleave import conv_transpose3d_interleave, upsample_eligible
from ..parallel.collectives import sharded_call

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}
_CONV_T_FN = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
UPSAMPLE = ("direct", "interleave")


def _he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``he_normal``: truncated normal at +-2 std with variance
    2 / fan_in (the std corrected for the truncation)."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _conv(conv: nn.Module, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Conv in the activation dtype with the module's f32 parameters."""
    return _CONV_FN[dim](x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                         conv.stride, conv.padding)


class InstanceNorm(nn.Module):
    """Affine per-sample, per-channel normalization over the spatial dims.
    Mirrors the JAX module (``unet.py:35-57``): one-pass f32 statistics
    E[x^2] - E[x]^2 clamped at 0, normalization in the activation dtype.
    A float64 input keeps float64 statistics, so an f64 model is an f64
    reference throughout."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * len(axes)
        xf = x if x.dtype == torch.float64 else x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.square().mean(dim=axes, keepdim=True) - mean.square()
        inv = torch.rsqrt(torch.clamp(var, min=0.0) + self.eps)
        dt = x.dtype
        return ((x - mean.to(dt)) * (inv * self.weight.view(shape)).to(dt)
                + self.bias.view(shape).to(dt))


class ConvNormAct(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU(0.01), routed as the module
    docstring says."""

    # the parameters model parallelism shards with the conv's output
    # channels, and their channel dim
    MP_PARAMS = (("conv.weight", 0), ("conv.bias", 0), ("norm.weight", 0), ("norm.bias", 0))

    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 stride: Sequence[int], use_kernels: bool = True,
                 negative_slope: float = 0.01, blocked_conv: bool = False):
        super().__init__()
        self.dim = len(kernel)
        self.conv = _CONV[self.dim](cin, cout, tuple(kernel), tuple(stride),
                                    padding=tuple(k // 2 for k in kernel))
        self.norm = InstanceNorm(cout)
        self.use_kernels = use_kernels
        self.blocked_conv = blocked_conv
        self.negative_slope = negative_slope
        self.fused = tuple(kernel) == (3, 3, 3) and tuple(stride) == (1, 1, 1)

    def packed_bs(self, x_shape) -> int | None:
        """The block size of the blocked route for an input of ``x_shape [B,
        Cin, *spatial]``, or None: the JAX gate ``_packed_bs`` without its TPU
        test and lane rule."""
        conv = self.conv
        if not (self.use_kernels and self.blocked_conv and len(x_shape) == 5
                and conv.kernel_size == (3, 3, 3)
                and conv.stride in ((1, 1, 1), (2, 2, 2))
                and max(conv.in_channels, conv.out_channels) <= 64):
            return None
        return pick_bs(x_shape[2:], prefer=(32, 16), batch=x_shape[0], min_blocks=16)

    def route(self, x_shape) -> str:
        """``"blocked"``, ``"fused"``, ``"conv"`` (cuDNN, then the
        InstanceNorm kernel) or ``"plain"``: the route an input of
        ``x_shape`` takes."""
        if not self.use_kernels:
            return "plain"
        if self.packed_bs(x_shape) is not None:
            return "blocked"
        return "fused" if self.fused else "conv"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sharded_call(self, x, self._forward, 1)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        bs = self.packed_bs(x.shape)
        if bs is not None:
            return packed_conv_in_lrelu(x, self.conv.weight, self.norm.weight,
                                        self.norm.bias, self.negative_slope, bs=bs,
                                        strides=self.conv.stride, bias=self.conv.bias)
        if self.use_kernels and self.fused:
            return conv3d_in_lrelu_cf(x, self.conv.weight, self.norm.weight,
                                      self.norm.bias, self.negative_slope,
                                      bias=self.conv.bias)
        y = _conv(self.conv, x, self.dim)
        if self.use_kernels:
            return instance_norm_leaky_cf(y, self.norm.weight, self.norm.bias,
                                          self.negative_slope)
        return F.leaky_relu(self.norm(y), self.negative_slope)


class ConvStage(nn.Module):
    """Two ConvNormAct blocks; the first may be strided (downsampling)."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 first_stride: Sequence[int], use_kernels: bool = True,
                 blocked_conv: bool = False):
        super().__init__()
        ones = (1,) * len(kernel)
        self.block0 = ConvNormAct(cin, cout, kernel, first_stride, use_kernels,
                                  blocked_conv=blocked_conv)
        self.block1 = ConvNormAct(cout, cout, kernel, ones, use_kernels,
                                  blocked_conv=blocked_conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block1(self.block0(x))


class GenericUNet(nn.Module):
    """Plans-driven U-Net.  ``forward(x [B, C_in, *spatial], capture_taps=False)``
    returns the deep-supervision logits, highest resolution first, each
    ``[B, num_classes, *spatial_i]`` float32 (float64 for an f64 model);
    with ``deep_supervision=False`` only the full-resolution head runs and
    the list has one entry.  ``blocked_conv`` and ``upsample`` (one of
    ``UPSAMPLE``) pick the CT-scale routes, ``remat`` recomputes the stages
    in the backward (module docstring)."""

    def __init__(self, in_channels: int, num_classes: int,
                 pool_op_kernel_sizes, conv_kernel_sizes,
                 base_num_features: int = 32, max_num_features: int = 320,
                 dtype: torch.dtype = torch.float32,
                 deep_supervision: bool = True, use_kernels: bool = True,
                 generator: torch.Generator | None = None,
                 blocked_conv: bool = False, upsample: str = "direct", remat: bool = False):
        super().__init__()
        if upsample not in UPSAMPLE:
            raise ValueError(f"upsample must be one of {UPSAMPLE}, got {upsample!r}")
        self.pool_op_kernel_sizes = tuple(tuple(k) for k in pool_op_kernel_sizes)
        self.conv_kernel_sizes = tuple(tuple(k) for k in conv_kernel_sizes)
        self.num_classes = num_classes
        self.base_num_features = base_num_features
        self.max_num_features = max_num_features
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        self.use_kernels = use_kernels
        self.upsample = upsample
        self.remat = remat
        self.dim = len(self.conv_kernel_sizes[0])
        dim, num_pool = self.dim, self.num_pool
        # registration order IS module_order(): named_children() follows it
        cin = in_channels
        for s in range(num_pool):
            stride = (1,) * dim if s == 0 else self.pool_op_kernel_sizes[s - 1]
            self.add_module(f"enc{s}", ConvStage(
                cin, self.stage_features(s), self.conv_kernel_sizes[s], stride,
                use_kernels, blocked_conv))
            cin = self.stage_features(s)
        self.bottleneck = ConvStage(
            cin, self.stage_features(num_pool), self.conv_kernel_sizes[num_pool],
            self.pool_op_kernel_sizes[-1], use_kernels, blocked_conv)
        cin = self.stage_features(num_pool)
        for d in range(num_pool):
            feats = self.stage_features(num_pool - 1 - d)
            up = self.pool_op_kernel_sizes[num_pool - 1 - d]
            self.add_module(f"up{d}", _CONV_T[dim](cin, feats, up, stride=up))
            self.add_module(f"dec{d}", ConvStage(
                2 * feats, feats, self.conv_kernel_sizes[num_pool - 1 - d],
                (1,) * dim, use_kernels, blocked_conv))
            cin = feats
        for d in range(num_pool):
            self.add_module(f"seg{d}", _CONV[dim](
                self.stage_features(num_pool - 1 - d), num_classes, 1))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @property
    def num_pool(self) -> int:
        return len(self.pool_op_kernel_sizes)

    def stage_features(self, stage: int) -> int:
        return int(min(self.base_num_features * 2 ** stage, self.max_num_features))

    def module_order(self) -> list:
        """Topological order of the top-level submodules (equal to the JAX
        model's ``module_order()``)."""
        order = [f"enc{s}" for s in range(self.num_pool)] + ["bottleneck"]
        for d in range(self.num_pool):
            order += [f"up{d}", f"dec{d}"]
        return order + [f"seg{d}" for d in range(self.num_pool)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers: He-normal conv and transposed-conv kernels
        (fan-in from the flax kernel layout), zero biases, unit/zero norm
        affine.  Deterministic for a given (CPU) generator."""
        for m in self.modules():
            if isinstance(m, tuple(_CONV.values())):
                _he_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, tuple(_CONV_T.values())):
                # torch [Cin, Cout, *k]; flax's fan-in is Cin * prod(k)
                _he_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(),
                            generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, InstanceNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _stage(self, name: str, *inputs: torch.Tensor) -> torch.Tensor:
        """Stage ``name`` on its input (a decoder stage: on its upsampled
        input and its skip, concatenated), checkpointed with ``remat``."""
        def run(*xs):
            return getattr(self, name)(xs[0] if len(xs) == 1 else torch.cat(xs, dim=1))
        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, *inputs, use_reentrant=False)
        return run(*inputs)

    def _encode(self, x: torch.Tensor) -> list:
        """The encoder stages' outputs (the skips), in the activation dtype."""
        if x.dim() != self.dim + 2:
            raise ValueError(f"model is {self.dim}D, input has shape {tuple(x.shape)}")
        h = x.to(self.dtype)
        skips = []
        for s in range(self.num_pool):
            h = self._stage(f"enc{s}", h)
            skips.append(h)
        return skips

    def forward(self, x: torch.Tensor, capture_taps: bool = False):
        """The logits; with ``capture_taps`` also the stage outputs that POD
        distils, ``(outputs, taps)`` with taps ``enc{s}``, ``bottleneck`` and
        ``dec{d}`` (the tensors the stages return, no copies)."""
        skips = self._encode(x)
        h = self._stage("bottleneck", skips[-1])
        taps = {f"enc{s}": skip for s, skip in enumerate(skips)}
        taps["bottleneck"] = h
        outputs = []
        for d in range(self.num_pool):
            h = self._stage(f"dec{d}", self._up(d, h), skips[-1 - d])
            taps[f"dec{d}"] = h
            if self.deep_supervision or d == self.num_pool - 1:
                outputs.append(self._seg(d, h))
        return (outputs[::-1], taps) if capture_taps else outputs[::-1]

    def interleaved(self, d: int, h_shape) -> bool:
        """Whether ``up{d}`` takes the interleave route for an input of
        ``h_shape``."""
        up = getattr(self, f"up{d}")
        return (self.use_kernels and self.upsample == "interleave"
                and up.stride == (2, 2, 2)
                and upsample_eligible(h_shape, up.kernel_size, up.stride))

    def _up(self, d: int, h: torch.Tensor) -> torch.Tensor:
        """The transposed conv ``up{d}`` in h's dtype."""
        up = getattr(self, f"up{d}")
        if self.interleaved(d, h.shape):
            return sharded_call(up, h, lambda x: conv_transpose3d_interleave(
                x, up.weight, up.bias), 1)
        return sharded_call(up, h, lambda x: _CONV_T_FN[self.dim](
            x, up.weight.to(x.dtype), up.bias.to(x.dtype), up.stride), 1)

    def _seg(self, d: int, h: torch.Tensor) -> torch.Tensor:
        """The logits of head ``seg{d}``, f32 (f64 for an f64 model)."""
        seg = getattr(self, f"seg{d}")
        logits = sharded_call(seg, h, lambda x: _conv(seg, x, self.dim), 1)
        return logits if logits.dtype == torch.float64 else logits.float()


def unet_from_plans(plans, config_name: str, dtype: torch.dtype = torch.float32,
                    deep_supervision: bool = True, use_kernels: bool = True,
                    generator: torch.Generator | None = None,
                    base_num_features: int | None = None,
                    max_num_features: int | None = None,
                    blocked_conv: bool = False, upsample: str = "direct",
                    remat: bool = False, in_channels: int | None = None) -> GenericUNet:
    """The U-Net a plans configuration describes.  ``base_num_features`` /
    ``max_num_features`` override the plans' widths, as a checkpoint
    manifest may (``training/restore.py``); ``blocked_conv`` / ``upsample``
    pick the CT-scale routes; ``remat`` recomputes the stages;
    ``in_channels`` (default the plans' modalities) is the cascade stage's
    modalities plus its one-hot channels."""
    cfg = plans.config(config_name)
    return GenericUNet(
        in_channels=in_channels or plans.num_modalities,
        num_classes=plans.num_classes + 1,
        pool_op_kernel_sizes=cfg.pool_op_kernel_sizes,
        conv_kernel_sizes=cfg.conv_kernel_sizes,
        base_num_features=base_num_features or cfg.base_num_features,
        max_num_features=max_num_features or cfg.max_num_features,
        dtype=dtype, deep_supervision=deep_supervision,
        use_kernels=use_kernels, generator=generator, blocked_conv=blocked_conv,
        upsample=upsample, remat=remat)


def ds_scale_factors(pool_op_kernel_sizes) -> list:
    """Cumulative downsampling factor of each deep-supervision output,
    highest resolution first: [1,1,1], pool[0], pool[0]*pool[1], ..."""
    dim = len(pool_op_kernel_sizes[0])
    factors = [np.ones(dim, dtype=np.int64)]
    acc = np.ones(dim, dtype=np.int64)
    for k in pool_op_kernel_sizes[:-1]:
        acc = acc * np.array(k)
        factors.append(acc.copy())
    return [tuple(int(x) for x in f) for f in factors]
