"""The plain reference U-Net: nnU-Net's generic U-Net (``topology.py``) as
a function of a dict of float32 parameters, in plain PyTorch with TF32
off.  It imports nothing of the program.

Parameter names follow the layers' names (``enc0.block0.conv.weight``,
``up1.weight``, ``seg2.bias``, ...); a conv weight is ``[Cout, Cin, *k]``,
a transposed conv's ``[Cin, Cout, *k]``.  ``quant`` (the control) rounds
every conv's input and weight to float8 e4m3 with a per-tensor scale, and
the gradients flowing back into them to e5m2.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..topology import unet_layers

SLOPE = 0.01
EPS = 1e-5
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convs in float32 (TF32 off), the flags
    restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).to(x.dtype) / s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def param_shapes(layers) -> dict:
    """{name: shape} of every parameter, in the layers' order."""
    out = {}
    for la in layers:
        if la.kind == "block":
            out[f"{la.name}.conv.weight"] = (la.cout, la.cin) + la.kernel
            out[f"{la.name}.conv.bias"] = (la.cout,)
            out[f"{la.name}.norm.weight"] = (la.cout,)
            out[f"{la.name}.norm.bias"] = (la.cout,)
        elif la.kind == "up":
            out[f"{la.name}.weight"] = (la.cin, la.cout) + la.kernel
            out[f"{la.name}.bias"] = (la.cout,)
        else:
            out[f"{la.name}.weight"] = (la.cout, la.cin) + la.kernel
            out[f"{la.name}.bias"] = (la.cout,)
    return out


def init_params(layers, seed: int, device) -> dict:
    """He-normal conv weights (std sqrt(2 / (Cin * prod(k)))), zero biases,
    unit / zero norm affines, drawn on ``device`` from ``seed`` in one call."""
    shapes = param_shapes(layers)
    weights = [n for n in shapes if n.endswith("weight") and not n.endswith("norm.weight")]
    total = sum(math.prod(shapes[n]) for n in weights)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in weights:
            fan_in = shape[1] * math.prod(shape[2:]) if not name.startswith("up") \
                else shape[0] * math.prod(shape[2:])
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        elif name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _instance_norm_lrelu(y, w, b):
    axes = tuple(range(2, y.dim()))
    mean = y.mean(dim=axes, keepdim=True)
    var = (y - mean).square().mean(dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * len(axes)
    z = (y - mean) * torch.rsqrt(var + EPS) * w.view(shape) + b.view(shape)
    return F.leaky_relu(z, SLOPE)


def forward(params: dict, x: torch.Tensor, layers, quant: bool = False) -> list:
    """The logits of every head in ``layers`` (highest resolution first),
    float32, for ``x [B, C, *spatial]``."""
    dim = x.dim() - 2
    conv = {2: F.conv2d, 3: F.conv3d}[dim]
    conv_t = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[dim]
    q = fp8 if quant else (lambda t: t)
    h, skips, outs = x, [], []
    for la in layers:
        p = params
        if la.kind == "block":
            if la.name.startswith("dec") and la.name.endswith("block0"):
                h = torch.cat([h, skips.pop()], dim=1)
            y = conv(q(h), q(p[f"{la.name}.conv.weight"]), p[f"{la.name}.conv.bias"],
                     la.stride, tuple(k // 2 for k in la.kernel))
            h = _instance_norm_lrelu(y, p[f"{la.name}.norm.weight"], p[f"{la.name}.norm.bias"])
            if la.name.startswith("enc") and la.name.endswith("block1"):
                skips.append(h)
        elif la.kind == "up":
            h = conv_t(q(h), q(p[f"{la.name}.weight"]), p[f"{la.name}.bias"], la.stride)
        else:
            outs.append(conv(q(h), q(p[f"{la.name}.weight"]), p[f"{la.name}.bias"]))
    return outs[::-1]


def layers_for(config: dict, deep_supervision: bool, spatial=None) -> list:
    plans = config["plans"]
    cfg = plans["configurations"][config["config_name"]]
    return unet_layers(cfg, plans["num_modalities"], plans["num_classes"] + 1,
                       spatial or cfg["patch_size"], deep_supervision)
