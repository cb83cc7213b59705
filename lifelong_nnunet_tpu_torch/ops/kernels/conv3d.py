"""Fused 3x3x3 stride-1 SAME conv + InstanceNorm + LeakyReLU, forward and
backward: the port of ``lifelong_nnunet_tpu/ops/pallas/conv3d.py::conv3d_in_lrelu``
(``_fused_fwd_impl`` and its custom VJP ``_fused_fwd`` / ``_fused_bwd``).

The CUDA kernels live in ``ops/csrc/conv3d_in_lrelu.cu`` (the conv with its
statistics and the normalizing finish; the conv alone for the data
gradient), ``ops/csrc/conv3d_wgrad.cu`` (the weight gradient) and
``ops/csrc/instance_norm.cu`` (the InstanceNorm backward).  A
tensor on the CPU goes through the plain PyTorch versions beside them
(:func:`plain_conv3d_in_lrelu`, :func:`plain_conv3d_in_lrelu_bwd`); a CUDA
tensor launches the kernels or raises, whatever its shape.  The conv has
two kernels, chosen by the input dtype: bf16 (training and serving) runs
the implicit GEMM on the tensor cores, on weights packed by
:func:`tc_weight` and split as :func:`tc_splits` says; f32 runs the f32 FMA
kernel on the CUDA cores, so an f32 check is not rounded to bf16 or TF32.
The conv's and the data gradient's wrappers count every launch in
``launches`` and the tensor-core ones again in ``tc_launches``; the weight
gradient's counts its one kernel's launches in ``launches``.

Where autograd records the call, :class:`Conv3dINLReLU` runs the training
forward (the raw conv output ``ycf`` and the f32 mean / inv kept beside the
output), and its backward runs, as ``_fused_bwd`` does: the InstanceNorm
backward on ``ycf`` (the wrapper of ``instance_norm.py``), the data
gradient as the same conv of dy with the taps flipped and Cin / Cout
swapped (a kernel, launched only when the input needs a gradient), and the
weight gradient (:func:`conv3d_weight_grad`): for bf16 x and dy, the
training dtype, a kernel on the tensor cores with f32 accumulation, split
over the voxels as :func:`wgrad_plan` says; for f32 input the library's
(``aten.convolution_backward``), as the JAX package leaves it to XLA.  The
CPU runs the same steps through the wrappers' plain versions.

``conv3d_in_lrelu`` keeps the JAX signature (channels-last ``x [B, D, H, W,
Cin]``, ``w [3, 3, 3, Cin, Cout]``); ``conv3d_in_lrelu_cf`` is the
channels-first entry the U-Net uses (``x [B, Cin, D, H, W]``, ``w`` in
``nn.Conv3d``'s ``[Cout, Cin, 3, 3, 3]``).  Like the TPU kernel, neither
uses a conv bias: the InstanceNorm mean subtraction absorbs it.  A bias
handed to ``conv3d_in_lrelu_cf`` gets a zero gradient, as the unused
parameter does in the JAX package, so the optimizer still decays it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .instance_norm import instance_norm_leaky_bwd_cf, plain_instance_norm_leaky_bwd

_ONES = (1, 1, 1)


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    return x.dtype if out_dtype is None else out_dtype


def _stats(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, None, None, None]


def plain_conv3d_in_lrelu_train(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                offset: torch.Tensor, negative_slope: float = 0.01,
                                epsilon: float = 1e-5, out_dtype=None):
    """(out, ycf, mean, inv): ``F.conv3d`` in x's dtype, one-pass f32
    statistics clamped at 0, and the TPU epilogue ``y * mul - sub`` with
    ``mul``/``sub`` rounded to the output dtype (``conv3d.py:262-268,
    288-290``); ``ycf`` is the conv output in the output dtype, ``mean`` /
    ``inv`` [B, Cout] f32."""
    dt = _out_dtype(x, out_dtype)
    y = F.conv3d(x, w.to(x.dtype), padding=1)
    yf = y.float()
    n = float(yf[0, 0].numel())
    mean = yf.sum(dim=(2, 3, 4)) / n                          # [B, Cout]
    var = torch.clamp(yf.square().sum(dim=(2, 3, 4)) / n - mean.square(), min=0.0)
    inv = torch.rsqrt(var + epsilon)
    mul = _stats((inv * scale.float()).to(dt).float())
    sub = _stats((mean * inv * scale.float() - offset.float()).to(dt).float())
    ycf = y.to(dt)
    z = ycf.float() * mul - sub
    return torch.where(z >= 0, z, negative_slope * z).to(dt), ycf, mean, inv


def plain_conv3d_in_lrelu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          offset: torch.Tensor, negative_slope: float = 0.01,
                          epsilon: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """Channels-first reference of the fused kernel (the output of
    :func:`plain_conv3d_in_lrelu_train`)."""
    return plain_conv3d_in_lrelu_train(x, w, scale, offset, negative_slope, epsilon,
                                       out_dtype)[0]


def _dx_weight(w: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, 3, 3, 3]`` -> the torch weight of the data-gradient
    conv, ``[Cin, Cout, 3, 3, 3]`` with the taps flipped."""
    return w.flip(2, 3, 4).transpose(0, 1)


def plain_conv3d_dx(dy: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """dx = conv(dy, flip(w) with Cin / Cout swapped), in dy's dtype."""
    return F.conv3d(dy, _dx_weight(w).to(dy.dtype), padding=1).to(_out_dtype(dy, out_dtype))


def plain_conv3d_weight_grad(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                             stride=_ONES) -> torch.Tensor:
    """dw of the 3x3x3 SAME conv at ``stride``, accumulated in f32 and
    returned in w's dtype: the library's weight gradient on x and dy cast
    to f32.  On the card cuDNN rounds those inputs to TF32 where
    ``torch.backends.cudnn.allow_tf32`` lets it (PyTorch's default): with
    f32 activations dw is then TF32's, as XLA's default precision for an
    f32 conv on a TPU is not full f32 either."""
    return torch.ops.aten.convolution_backward(
        dy.float(), x.float(), w.float(), None, tuple(stride), _ONES, _ONES, False,
        (0, 0, 0), 1, (False, True, False))[1].to(w.dtype)


def plain_conv3d_in_lrelu_bwd(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                              offset: torch.Tensor, ycf: torch.Tensor, mean: torch.Tensor,
                              inv: torch.Tensor, g: torch.Tensor,
                              negative_slope: float = 0.01, need_dx: bool = True):
    """``_fused_bwd`` step by step: the InstanceNorm backward of
    :func:`plain_instance_norm_leaky_bwd` on (ycf, mean, inv) (the LeakyReLU
    mask recomputed, dy rounded to x's dtype), dx by the flipped conv, dw in
    f32.  Returns (dx or None, dw, dscale [Cout], doffset [Cout])."""
    dy, dscale, doffset = plain_instance_norm_leaky_bwd(
        ycf, scale, offset, mean, inv, g, negative_slope, dx_dtype=x.dtype)
    dx = plain_conv3d_dx(dy, w, x.dtype) if need_dx else None
    return dx, plain_conv3d_weight_grad(x, w, dy), dscale, doffset


def _check(x, w, scale, offset, dt) -> None:
    if x.dtype not in build.DTYPES or dt not in build.DTYPES:
        raise TypeError(f"conv3d_in_lrelu kernel takes float32/bfloat16, got "
                        f"{x.dtype} -> {dt}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3) \
            or scale.shape != w.shape[:1] or offset.shape != w.shape[:1]:
        raise ValueError(f"conv3d_in_lrelu takes x [B, Cin, D, H, W] and w "
                         f"[Cout, Cin, 3, 3, 3]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}, "
                         f"offset {tuple(offset.shape)}")


def _kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[Cout, Cin, kd, kh, kw] -> [Cin, 27, Cout], in the input dtype as the
    TPU kernel casts its weights (conv3d.py:220): the FMA kernel's layout."""
    return w.to(dtype).permute(1, 2, 3, 4, 0).contiguous().view(w.shape[1], 27, w.shape[0])


# the tensor-core kernel's tiling (conv3d_in_lrelu.cu, namespace tc): a block
# owns a TC_BOX of output voxels of one batch item and 32 or 64 output
# channels; K runs over chunks of TC_CHUNK input channels, split over
# several blocks when the grid would not fill the card's SMs (an H100 SXM
# has 132).  The kernel sizes its scratch itself (the extension's
# ``conv3d_tc_partials_len`` / ``conv3d_tc_workspace_len``); the wrapper
# chooses the split and packs the weights.
TC_BOX = (4, 8, 8)
TC_CHUNK = 16
TC_SMS = 132


def tc_n_tile(cout: int) -> int:
    """Output channels a block: 32 when Cout <= 32, else 64."""
    return 32 if cout <= 32 else 64


def tc_splits(batch: int, cin: int, cout: int, spatial) -> int:
    """The blocks the input-channel chunks of one tensor-core conv are split
    over, a pure function of its shape: the fewest that fill the SMs (1 once
    the grid has TC_SMS blocks), with none left empty (split s takes chunks
    [s * ceil(chunks / splits), (s + 1) * ceil(chunks / splits)))."""
    m_tiles = math.prod(-(-s // t) for s, t in zip(spatial, TC_BOX))
    blocks = batch * m_tiles * -(-cout // tc_n_tile(cout))
    chunks = -(-cin // TC_CHUNK)
    if blocks >= TC_SMS:
        return 1
    want = min(chunks, -(-TC_SMS // blocks))   # splits that fill the SMs
    return -(-chunks // -(-chunks // want))   # ... with none left empty


def tc_weight(w: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, kd, kh, kw] -> the tensor-core kernel's packed bf16
    weights ``[chunks, 27, Cout_pad, TC_CHUNK]`` (tap = 9 kd + 3 kh + kw;
    Cin padded with zeros to the chunk, Cout to the channel tile).  With one
    input channel the kernel folds (kh, kw) into the chunk: ``[1, 3,
    Cout_pad, TC_CHUNK]``, tap kd, channel 3 kh + kw (9 of 16 used)."""
    cout, cin = w.shape[:2]
    nt = tc_n_tile(cout)
    cout_pad, chunks = -(-cout // nt) * nt, -(-cin // TC_CHUNK)
    if cin == 1:
        wp = torch.zeros((cout_pad, 3, TC_CHUNK), dtype=torch.bfloat16, device=w.device)
        wp[:cout, :, :9] = w.reshape(cout, 3, 9)
        return wp.permute(1, 0, 2).unsqueeze(0).contiguous()
    wp = torch.zeros((cout_pad, chunks * TC_CHUNK, 27), dtype=torch.bfloat16, device=w.device)
    wp[:cout, :cin] = w.reshape(cout, cin, 27)
    return wp.view(cout_pad, chunks, TC_CHUNK, 27).permute(1, 3, 0, 2).contiguous()


def _kernel_forward(x, w, scale, offset, negative_slope, epsilon, out_dtype, train):
    """One launch of the fused forward: ``out`` (normalized in place) or,
    for training, (out, ycf, mean, inv).  bf16 x runs the tensor-core
    kernel, f32 x the FMA kernel."""
    dev = build.require_cuda(x, w, scale, offset)
    dt = _out_dtype(x, out_dtype)
    _check(x, w, scale, offset, dt)
    B, cin, D, H, W = x.shape
    cout = w.shape[0]
    ext = build.load_extension()
    tc = x.dtype == torch.bfloat16
    y = torch.empty((B, cout, D, H, W), dtype=dt, device=dev)
    if tc:
        splits = tc_splits(B, cin, cout, (D, H, W))
        partials = torch.empty(ext.conv3d_tc_partials_len(B, cout, D, H, W, splits),
                               dtype=torch.float32, device=dev)
        tail = (torch.empty(ext.conv3d_tc_workspace_len(B, cout, D, H, W, splits),
                            dtype=torch.float32, device=dev), splits)
        args = (x.contiguous(), tc_weight(w))
    else:
        partials = torch.empty(ext.conv3d_partials_len(B, cout, D, H, W),
                               dtype=torch.float32, device=dev)
        tail = ()
        args = (x.contiguous(), _kernel_weight(w, x.dtype))
    args += (scale.float().contiguous(), offset.float().contiguous())
    finish = (float(negative_slope), float(epsilon))
    if train:
        out = torch.empty_like(y)
        mean = torch.empty((B, cout), dtype=torch.float32, device=dev)
        inv = torch.empty_like(mean)
        fn = ext.conv3d_tc_in_lrelu_train_fwd if tc else ext.conv3d_in_lrelu_train_fwd
        fn(*args, y, out, mean, inv, partials, *tail, *finish)
        result = (out, y, mean, inv)
    else:
        fn = ext.conv3d_tc_in_lrelu_fwd if tc else ext.conv3d_in_lrelu_fwd
        fn(*args, y, partials, *tail, *finish)
        result = y
    conv3d_in_lrelu_cf.launches += 1
    conv3d_in_lrelu_cf.tc_launches += tc
    return result


def conv3d_dx_cf(dy: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The fused op's data gradient: ``dy [B, Cout, D, H, W]``, ``w [Cout,
    Cin, 3, 3, 3]`` -> ``dx [B, Cin, D, H, W]`` in ``out_dtype`` (default
    dy's).  One launch of the conv for a CUDA tensor: on the tensor cores
    for bf16 dy, the FMA kernel for f32."""
    if dy.device.type == "cpu":
        return plain_conv3d_dx(dy, w, out_dtype)
    dev = build.require_cuda(dy, w)
    dt = _out_dtype(dy, out_dtype)
    if dy.dtype not in build.DTYPES or dt not in build.DTYPES:
        raise TypeError(f"conv3d kernel takes float32/bfloat16, got {dy.dtype} -> {dt}")
    if dy.dim() != 5 or w.dim() != 5 or w.shape[0] != dy.shape[1] \
            or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"conv3d_dx takes dy [B, Cout, D, H, W] and w [Cout, Cin, 3, "
                         f"3, 3]; got {tuple(dy.shape)}, {tuple(w.shape)}")
    B, cout, D, H, W = dy.shape
    cin = w.shape[1]
    ext = build.load_extension()
    dx = torch.empty((B, cin, D, H, W), dtype=dt, device=dev)
    tc = dy.dtype == torch.bfloat16
    if tc:
        splits = tc_splits(B, cout, cin, (D, H, W))
        ext.conv3d_tc_fwd(dy.contiguous(), tc_weight(_dx_weight(w)), dx,
                          torch.empty(ext.conv3d_tc_workspace_len(B, cin, D, H, W, splits),
                                      dtype=torch.float32, device=dev), splits)
    else:
        ext.conv3d_fwd(dy.contiguous(), _kernel_weight(_dx_weight(w), dy.dtype), dx)
    conv3d_dx_cf.launches += 1
    conv3d_dx_cf.tc_launches += tc
    return dx


conv3d_dx_cf.launches = conv3d_dx_cf.tc_launches = 0


# the weight-gradient kernel's tiling (conv3d_wgrad.cu, namespace wg): a
# block holds the dw tile of one chunk of WG_CHUNK input channels at the 27
# taps (a single input channel's taps folded into one chunk) against 32 or
# 64 output channels (``tc_n_tile``), and walks a run of WG_BOX voxel boxes
WG_BOX = (4, 8, 8)
WG_CHUNK = 16


class WgradPlan(NamedTuple):
    """The launch of one weight gradient on the tensor cores: ``n_tiles``
    output-channel tiles of ``n_tile``, ``chunks`` input-channel chunks,
    ``boxes`` voxel boxes (``per_item`` per batch item, in the order item,
    d, h, w) in ``splits`` runs of ``per_split`` (the last may be shorter);
    the grid is (splits, n_tiles, chunks), and the splits' f32 partials
    ([splits, Cout, Cin, 27]) are summed in split order."""
    n_tile: int
    n_tiles: int
    chunks: int
    per_item: int
    boxes: int
    splits: int
    per_split: int

    def split_boxes(self, split: int) -> range:
        """The boxes split ``split`` walks, in order."""
        return range(split * self.per_split, min(self.boxes, (split + 1) * self.per_split))

    def workspace_len(self, cin: int, cout: int) -> int:
        return self.splits * cout * cin * 27 if self.splits > 1 else 0


def wgrad_plan(batch: int, cin: int, cout: int, spatial) -> WgradPlan:
    """The weight-gradient kernel's launch plan, a pure function of the
    shape: as many splits of the voxel boxes as fit the blocks of the
    channel tiles into one wave on TC_SMS SMs (one block an SM), none
    empty; a single run where the channel tiles alone fill the SMs."""
    n_tile = tc_n_tile(cout)
    n_tiles, chunks = -(-cout // n_tile), -(-cin // WG_CHUNK)
    per_item = math.prod(-(-s // t) for s, t in zip(spatial, WG_BOX))
    boxes = batch * per_item
    want = min(boxes, max(1, TC_SMS // (n_tiles * chunks)))
    per_split = -(-boxes // want)
    return WgradPlan(n_tile, n_tiles, chunks, per_item, boxes, -(-boxes // per_split),
                     per_split)


def conv3d_weight_grad(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                       stride=_ONES) -> torch.Tensor:
    """dw of the 3x3x3 SAME conv at ``stride`` (``_fused_bwd``'s XLA
    weight-grad, ``conv3d.py:351-360``; the blocked route's, ``block_pack.py:
    334-341``), accumulated in f32 and returned in w's dtype.  bf16 x and
    dy on the card at stride 1, the training path, run the tensor-core
    kernel: bf16 x bf16 products exact in f32, summed in f32, as the
    library's TF32 path on f32 copies computes them (a bf16 value is a TF32
    value), in another order.  f32 input (the f32 checks) and stride 2 (the
    blocked route's strided convs) take :func:`plain_conv3d_weight_grad`'s
    library call on the card too; a CPU tensor takes it as the plain
    version.  ``launches`` counts the kernel's launches alone."""
    if x.device.type == "cpu":
        return plain_conv3d_weight_grad(x, w, dy, stride)
    if x.dtype != torch.bfloat16 or tuple(stride) != _ONES:
        return plain_conv3d_weight_grad(x, w, dy, stride)
    dev = build.require_cuda(x, w, dy)
    if dy.dtype != x.dtype or x.dim() != 5 or w.dim() != 5 or dy.dim() != 5 \
            or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3) \
            or tuple(dy.shape) != (x.shape[0], w.shape[0]) + tuple(x.shape[2:]):
        raise ValueError(f"conv3d_weight_grad takes bf16 x [B, Cin, D, H, W], w [Cout, Cin, "
                         f"3, 3, 3] and dy [B, Cout, D, H, W] in x's dtype; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(dy.shape)} {dy.dtype}")
    B, cin, D, H, W = x.shape
    cout = w.shape[0]
    plan = wgrad_plan(B, cin, cout, (D, H, W))
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=dev)
    ws = torch.empty(plan.workspace_len(cin, cout), dtype=torch.float32, device=dev)
    build.load_extension().conv3d_wgrad_tc(x.contiguous(), dy.contiguous(), dw, ws,
                                           plan.splits)
    conv3d_weight_grad.launches += 1
    return dw.to(w.dtype)


conv3d_weight_grad.launches = 0


class Conv3dINLReLU(torch.autograd.Function):
    """``jax.custom_vjp`` of ``conv3d_in_lrelu`` (``_fused_fwd`` /
    ``_fused_bwd``) as an autograd Function.  The forward saves x, w, scale,
    offset, ycf, mean and inv (not the output)."""

    @staticmethod
    def forward(ctx, x, w, scale, offset, bias, negative_slope, epsilon, out_dtype):
        if x.device.type == "cpu":
            out, ycf, mean, inv = plain_conv3d_in_lrelu_train(
                x, w, scale, offset, negative_slope, epsilon, out_dtype)
        else:
            out, ycf, mean, inv = _kernel_forward(x, w, scale, offset, negative_slope,
                                                  epsilon, out_dtype, train=True)
        ctx.save_for_backward(x, w, scale, offset, ycf, mean, inv)
        ctx.negative_slope = negative_slope
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, offset, ycf, mean, inv = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        # the IN part of _fused_bwd is _bwd_kernel with x := ycf and
        # rstd := inv: one wrapper for both, dy written in x's dtype; on the
        # CPU the two wrappers run plain_conv3d_in_lrelu_bwd's steps
        dy, dscale, doffset = instance_norm_leaky_bwd_cf(
            ycf, scale, offset, mean, inv, g, ctx.negative_slope, dx_dtype=x.dtype)
        dx = conv3d_dx_cf(dy, w, x.dtype) if need_dx else None
        dw = conv3d_weight_grad(x, w, dy)
        dbias = torch.zeros(w.shape[:1], dtype=w.dtype, device=w.device) \
            if ctx.has_bias else None
        return (dx, dw, dscale.to(scale.dtype), doffset.to(offset.dtype), dbias,
                None, None, None)


def conv3d_in_lrelu_cf(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor, negative_slope: float = 0.01,
                       epsilon: float = 1e-5, out_dtype=None,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """conv3d(3^3, stride 1, SAME, no bias) -> InstanceNorm -> LeakyReLU.
    ``x [B, Cin, D, H, W]``, ``w [Cout, Cin, 3, 3, 3]``, ``scale``/``offset``
    [Cout].  Returns ``[B, Cout, D, H, W]`` in ``out_dtype`` (default x's).
    Differentiable through :class:`Conv3dINLReLU` where autograd records;
    ``bias`` (the conv's, unused by the math) then gets a zero gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, offset, bias)):
        return Conv3dINLReLU.apply(x, w, scale, offset, bias, negative_slope, epsilon,
                                   out_dtype)
    if x.device.type == "cpu":
        return plain_conv3d_in_lrelu(x, w, scale, offset, negative_slope, epsilon,
                                     out_dtype)
    return _kernel_forward(x, w, scale, offset, negative_slope, epsilon, out_dtype,
                           train=False)


conv3d_in_lrelu_cf.launches = conv3d_in_lrelu_cf.tc_launches = 0


def conv3d_in_lrelu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, negative_slope: float = 0.01,
                    epsilon: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """The JAX signature: channels-last ``x [B, D, H, W, Cin]``,
    ``w [3, 3, 3, Cin, Cout]``; returns channels-last ``[B, D, H, W, Cout]``."""
    y = conv3d_in_lrelu_cf(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                           scale, offset, negative_slope, epsilon, out_dtype)
    return y.permute(0, 2, 3, 4, 1)
