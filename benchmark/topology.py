"""The layers of nnU-Net's generic U-Net as a configuration's plans define
them: the one description that the plain reference model and the work
arithmetic both read.

The topology is nnU-Net v1's ``Generic_UNet``: ``num_pool + 1`` encoder
stages of two conv + InstanceNorm + LeakyReLU blocks (the first block of
every stage after the first strided by the pool), ``num_pool`` decoder
stages, each a transposed conv of kernel = stride = the pool, the
concatenation with the skip and two blocks, and a 1x1 head after every
decoder stage (deep supervision; only the last one when serving).
Features are ``min(base * 2^stage, max)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Layer:
    name: str          # the parameter prefix, e.g. "enc1.block0", "up0", "seg3"
    kind: str          # "block" (conv + InstanceNorm + LeakyReLU), "up" or "head"
    cin: int
    cout: int
    kernel: tuple
    stride: tuple
    in_spatial: tuple
    out_spatial: tuple

    @property
    def fused(self) -> bool:
        """A stride-1 3x3x3 block: the fused conv + InstanceNorm + LeakyReLU
        function."""
        return self.kind == "block" and self.kernel == (3, 3, 3) and self.stride == (1, 1, 1)

    def conv_flops(self, batch: int) -> int:
        """Multiply-adds x 2 of the layer's conv (no bias)."""
        taps = math.prod(self.kernel)
        if self.kind == "up":      # kernel == stride: each input voxel feeds prod(k) outputs
            return 2 * batch * self.cin * self.cout * taps * math.prod(self.in_spatial)
        return 2 * batch * self.cin * self.cout * taps * math.prod(self.out_spatial)


def features(cfg: dict, stage: int) -> int:
    return int(min(cfg["base_num_features"] * 2 ** stage, cfg["max_num_features"]))


def _down(spatial, stride):
    # a conv of kernel 3 (or 1), padding k // 2 and this stride
    return tuple(-(-s // st) for s, st in zip(spatial, stride))


def unet_layers(cfg: dict, in_channels: int, num_classes: int, spatial,
                deep_supervision: bool = True) -> list:
    """Every layer of the U-Net of the plans configuration ``cfg`` (a dict
    with ``pool_op_kernel_sizes``, ``conv_kernel_sizes``,
    ``base_num_features``, ``max_num_features``) on an input of ``spatial``
    voxels, in the order of the forward pass."""
    pools = [tuple(p) for p in cfg["pool_op_kernel_sizes"]]
    kernels = [tuple(k) for k in cfg["conv_kernel_sizes"]]
    dim, n = len(kernels[0]), len(pools)
    ones = (1,) * dim
    out, sizes = [], []
    cin, sp = in_channels, tuple(spatial)
    for s in range(n + 1):
        name = f"enc{s}" if s < n else "bottleneck"
        stride = ones if s == 0 else pools[s - 1]
        f = features(cfg, s)
        sp1 = _down(sp, stride)
        out.append(Layer(f"{name}.block0", "block", cin, f, kernels[s], stride, sp, sp1))
        out.append(Layer(f"{name}.block1", "block", f, f, kernels[s], ones, sp1, sp1))
        cin, sp = f, sp1
        sizes.append(sp1)
    for d in range(n):
        s = n - 1 - d
        f = features(cfg, s)
        up = pools[s]
        sp_up = tuple(a * b for a, b in zip(sp, up))
        out.append(Layer(f"up{d}", "up", cin, f, up, up, sp, sp_up))
        out.append(Layer(f"dec{d}.block0", "block", 2 * f, f, kernels[s], ones, sp_up, sp_up))
        out.append(Layer(f"dec{d}.block1", "block", f, f, kernels[s], ones, sp_up, sp_up))
        if deep_supervision or d == n - 1:
            out.append(Layer(f"seg{d}", "head", f, num_classes, ones, ones, sp_up, sp_up))
        cin, sp = f, sp_up
    return out


def ds_factors(cfg: dict) -> list:
    """The downsampling factor of each deep-supervision output, highest
    resolution first."""
    pools = [tuple(p) for p in cfg["pool_op_kernel_sizes"]]
    acc = (1,) * len(pools[0])
    out = [acc]
    for p in pools[:-1]:
        acc = tuple(a * b for a, b in zip(acc, p))
        out.append(acc)
    return out
