"""Generic_ViT_UNet in PyTorch: the port of
``lifelong_nnunet_tpu/models/vit_unet.py``, the plans-driven U-Net with a
Vision Transformer at one of four placements.

  * **V1**: the ViT takes the first skip; its output, resized to the
    bottleneck's spatial dims, replaces the bottleneck's output as the
    decoder input.  The bottleneck's output is dead, so it is not run (XLA
    drops the dead stage in the JAX package); its parameters stay, get zero
    gradients from the optimizer, and keep checkpoints and the multi-head
    split unchanged.  Only a forward that captures taps runs it, for its
    ``bottleneck`` tap (POD then reaches its parameters).
  * **V2**: the ViT takes the first skip plus the bottleneck taken through
    the whole transposed-conv chain.
  * **V3**: the ViT takes the sum of all skips (each through the remaining
    transposed convs) plus the upsampled bottleneck.
  * **V4**: the shared-block ViT (per-stage patch embeddings and heads) is
    applied to every decoder stage's output before its seg head.

``ln_tasks`` gives the ViT task-specific LayerNorms (``models/vit.py``);
every ViT call, in V1-V3 and in each V4 stage, uses the set of task
``active_task_idx`` (the JAX model's static field).

The ViT's output grid is resized to the target spatial dims the way
``jax.image.resize(..., "linear")`` does it (:func:`linear_resize`).
``module_order()`` is the JAX model's (``vit`` after ``bottleneck``; after
the decoder for V4), and so is the registration order.  The ViT's
parameters are sized from ``patch_size``, the input's spatial shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .unet import GenericUNet
from .vit import VisionTransformer, vit_kwargs_for_type

VERSIONS = ("V1", "V2", "V3", "V4")


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` weights of ``jax.image.resize``'s linear method on one
    axis (``compute_weight_mat`` of ``jax/_src/image/scale.py``): a triangle
    kernel at half-pixel centres, widened by 1 / scale when downsampling
    (the antialiasing filter), columns normalized, samples outside the
    input zeroed."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def linear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="linear")`` of channels-first
    ``x [B, C, *spatial]`` to ``size``: one weight matrix per spatial axis
    whose size changes, applied in x's dtype.  ``F.interpolate``'s trilinear
    mode has no antialiasing and differs where an axis shrinks."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape[2:], size)):
        if n_in != n_out:
            w = torch.from_numpy(_resize_weights(n_in, n_out)).to(x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([axis + 2], [0])).movedim(-1, axis + 2)
    return x


def _conv_out(spatial, conv) -> tuple:
    """Spatial output shape of ``conv`` on ``spatial``."""
    return tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                 zip(spatial, conv.padding, conv.kernel_size, conv.stride))


class GenericViTUNet(GenericUNet):
    """``GenericUNet`` with the ViT ``vit`` (see the module docstring).
    ``vit_embed_dim`` / ``vit_depth`` / ``vit_heads`` override the
    ``vit_type`` preset.  The generator initializes the U-Net, then the
    ViT.  ``blocked_conv`` / ``upsample`` go to the U-Net body, as the JAX
    model forwards its conv routes (``vit_unet.py:66-72, 120``).  The JAX
    model builds its stages without ``stage_cls``, so its ``remat`` does
    nothing here: the ViT-U-Net has no ``remat``."""

    def __init__(self, in_channels: int, num_classes: int, pool_op_kernel_sizes,
                 conv_kernel_sizes, patch_size, base_num_features: int = 32,
                 max_num_features: int = 320, dtype: torch.dtype = torch.float32,
                 deep_supervision: bool = True, use_kernels: bool = True,
                 generator: torch.Generator | None = None, vit_version: str = "V1",
                 vit_type: str = "base", lsa: bool = False, spt: bool = False,
                 vit_embed_dim: int | None = None, vit_depth: int | None = None,
                 vit_heads: int | None = None, blocked_conv: bool = False,
                 upsample: str = "direct", ln_tasks=(), active_task_idx: int = 0):
        if vit_version not in VERSIONS:
            raise ValueError(f"unknown vit_version {vit_version!r}; options {VERSIONS}")
        gen = generator or torch.Generator().manual_seed(0)
        super().__init__(in_channels, num_classes, pool_op_kernel_sizes, conv_kernel_sizes,
                         base_num_features, max_num_features, dtype, deep_supervision,
                         use_kernels, gen, blocked_conv, upsample)
        self.vit_version, self.vit_type, self.lsa, self.spt = vit_version, vit_type, lsa, spt
        self.patch_size = tuple(patch_size)
        self.ln_tasks, self.active_task_idx = tuple(ln_tasks), int(active_task_idx)
        sizes = vit_kwargs_for_type(vit_type)
        for key, value in (("embed_dim", vit_embed_dim), ("depth", vit_depth),
                           ("num_heads", vit_heads)):
            if value:
                sizes[key] = value
        n = self.num_pool
        spatial = []      # of each skip
        for s in range(n):
            spatial.append(_conv_out(spatial[-1] if spatial else self.patch_size,
                                     getattr(self, f"enc{s}").block0.conv))
        if vit_version == "V4":
            stages = [n - 1 - d for d in range(n)]
            in_shapes = [(self.stage_features(s),) + spatial[s] for s in stages]
            out = [self.stage_features(s) for s in stages]
        else:
            in_shapes = [(self.stage_features(0),) + spatial[0]]
            out = [self.stage_features(n)]
        self.vit = VisionTransformer(in_shapes, out, lsa=lsa, spt=spt,
                                     use_kernels=use_kernels, generator=gen,
                                     ln_tasks=self.ln_tasks, **sizes)
        modules = dict(self._modules)
        self._modules.clear()
        self._modules.update((name, modules[name]) for name in self.module_order())

    def module_order(self) -> list:
        order = [f"enc{s}" for s in range(self.num_pool)] + ["bottleneck"]
        if self.vit_version != "V4":
            order.append("vit")
        for d in range(self.num_pool):
            order += [f"up{d}", f"dec{d}"]
        if self.vit_version == "V4":
            order.append("vit")
        return order + [f"seg{d}" for d in range(self.num_pool)]

    def forward(self, x: torch.Tensor, capture_taps: bool = False):
        """The logits; with ``capture_taps`` also ``(outputs, taps)``, the JAX
        model's taps: ``enc{s}``, ``bottleneck`` (V1 then runs its
        bottleneck stage), ``vit`` (V1-V3: the ViT's output grid before the
        resize), ``dec{d}`` and, in V4, ``vit_dec{d}`` (the resized ViT
        output that replaces ``dec{d}``'s)."""
        skips = self._encode(x)
        n = self.num_pool
        taps = {f"enc{s}": skip for s, skip in enumerate(skips)}
        if self.vit_version == "V1" and not capture_taps:
            h, size = None, _conv_out(skips[-1].shape[2:], self.bottleneck.block0.conv)
        else:
            h = self.bottleneck(skips[-1])
            taps["bottleneck"], size = h, h.shape[2:]
            h = None if self.vit_version == "V1" else h
        if self.vit_version != "V4":
            taps["vit"] = self.vit(self._vit_input(skips, h), task_idx=self.active_task_idx)
            h = linear_resize(taps["vit"], size).to(self.dtype)
        outputs = []
        for d in range(n):
            h = getattr(self, f"dec{d}")(torch.cat([self._up(d, h), skips[-1 - d]], dim=1))
            taps[f"dec{d}"] = h
            if self.vit_version == "V4":
                v = self.vit(h, idx=d, task_idx=self.active_task_idx)
                h = linear_resize(v, h.shape[2:]).to(self.dtype)
                taps[f"vit_dec{d}"] = h
            if self.deep_supervision or d == n - 1:
                outputs.append(self._seg(d, h))
        return (outputs[::-1], taps) if capture_taps else outputs[::-1]

    def _vit_input(self, skips: list, bottleneck: torch.Tensor | None) -> torch.Tensor:
        """V1-V3 ViT input; the transposed convs are the decoder's."""
        if self.vit_version == "V1":
            return skips[0]

        def upchain(t, start):
            for u in range(start, self.num_pool):
                t = self._up(u, t)
            return t

        acc = skips[0] if self.vit_version == "V2" else 0
        acc = acc + upchain(bottleneck, 0)
        if self.vit_version == "V3":
            for idx, skip in enumerate(reversed(skips)):
                acc = acc + upchain(skip, idx + 1)
        return acc


def vit_overrides(depth: int | None) -> dict:
    """The trainer's ``vit_depth_override`` (the JAX trainer's, tests and small
    runs): depth ``d``, embed ``max(16, 8 d)``, 2 heads; none for None."""
    if not depth:
        return {}
    return {"vit_depth": depth, "vit_embed_dim": max(16, 8 * depth), "vit_heads": 2}


def vit_unet_from_plans(plans, config_name: str, patch_size=None,
                        dtype: torch.dtype = torch.float32, vit_version: str = "V1",
                        vit_type: str = "base", lsa: bool = False, spt: bool = False,
                        deep_supervision: bool = True, use_kernels: bool = True,
                        generator: torch.Generator | None = None,
                        base_num_features: int | None = None,
                        max_num_features: int | None = None, blocked_conv: bool = False,
                        upsample: str = "direct", ln_tasks=(), active_task_idx: int = 0,
                        in_channels: int | None = None, **overrides) -> GenericViTUNet:
    """The ViT-U-Net a plans configuration describes, for inputs of
    ``patch_size`` (default the plans'); ``overrides``: ``vit_embed_dim``,
    ``vit_depth``, ``vit_heads`` (see :func:`vit_overrides`); ``ln_tasks``
    and ``active_task_idx``: the task-specific LayerNorms; ``in_channels``
    (default the plans' modalities): the cascade stage's input."""
    cfg = plans.config(config_name)
    return GenericViTUNet(
        in_channels=in_channels or plans.num_modalities, num_classes=plans.num_classes + 1,
        pool_op_kernel_sizes=cfg.pool_op_kernel_sizes,
        conv_kernel_sizes=cfg.conv_kernel_sizes,
        patch_size=tuple(patch_size or cfg.patch_size),
        base_num_features=base_num_features or cfg.base_num_features,
        max_num_features=max_num_features or cfg.max_num_features,
        dtype=dtype, deep_supervision=deep_supervision, use_kernels=use_kernels,
        generator=generator, vit_version=vit_version, vit_type=vit_type, lsa=lsa,
        spt=spt, blocked_conv=blocked_conv, upsample=upsample, ln_tasks=ln_tasks,
        active_task_idx=active_task_idx, **overrides)
