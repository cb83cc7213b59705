"""Parameters of the JAX U-Net or ViT-U-Net -> ``state_dict`` of the port's.

The JAX package keeps flax trees of float32 arrays: conv kernels
``[*k, Cin, Cout]`` (``DHWIO``), transposed-conv kernels in the same layout
applied as a cross-correlation on the dilated input (``lax.conv_transpose``
without ``transpose_kernel``), InstanceNorm ``scale``/``bias``.  PyTorch
wants ``[Cout, Cin, *k]`` for convs and, for ``ConvTranspose``, the conv
gradient's ``[Cin, Cout, *k]`` with the spatial taps flipped.  The mapping
follows ``tests/test_model_parity_torch.py:56-68, 114-122``.  Conv biases
are copied even where the fused kernel ignores them.

The ViT (``vit``): Dense kernels ``[in, out]`` become Linear weights ``[out,
in]``; the patch projection's kernel ``[*p, C, E]`` becomes the conv layout
``[E, C, *p]``; a LayerNorm's ``scale`` is its ``weight``, and the
``LayerNorm_0`` scope of a ``TaskLayerNorm`` is dropped (SPT's own
``LayerNorm_0`` is its ``norm``); position embeddings and LSA temperatures
are copied as they are.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .unet import GenericUNet


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _vit_entries(params, conv_perm) -> dict:
    """The ViT's flax tree -> {port key under ``vit.``: array}."""
    sd = {}
    for path, value in _flatten(params):
        *scopes, leaf = path
        value = np.asarray(value)
        if "LayerNorm_0" in scopes:
            at = scopes.index("LayerNorm_0")
            spt = at == 1 and scopes[0].startswith("patch_embed_")
            scopes = scopes[:at] + (["norm"] if spt else []) + scopes[at + 1:]
        if leaf == "scale":
            leaf = "weight"
        elif leaf == "kernel":
            leaf = "weight"
            value = value.transpose(conv_perm) if scopes[-1] == "proj" and \
                scopes[0].startswith("patch_embed_") else value.T
        sd[".".join(["vit"] + scopes + [leaf])] = value
    return sd


def jax_params_to_state_dict(params, model: GenericUNet) -> dict:
    """``params``: the JAX model's parameter tree (nested dicts of numpy or
    jax arrays, top-level keys ``enc0``, ``bottleneck``, ``up0``, ...,
    ``vit`` for a ViT-U-Net).  Returns a ``state_dict`` for ``model``;
    raises if a key or shape disagrees."""
    dim = model.dim
    conv_perm = (dim + 1, dim) + tuple(range(dim))
    convt_perm = (dim, dim + 1) + tuple(range(dim))
    sd = {}
    for name in model.module_order():
        p = params[name]
        if name == "vit":
            sd.update(_vit_entries(p, conv_perm))
        elif name.startswith("up"):
            k = np.flip(np.asarray(p["kernel"]), axis=tuple(range(dim)))
            sd[f"{name}.weight"] = k.transpose(convt_perm)
            sd[f"{name}.bias"] = p["bias"]
        elif name.startswith("seg"):
            sd[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(conv_perm)
            sd[f"{name}.bias"] = p["bias"]
        else:
            for blk in ("block0", "block1"):
                conv, norm = p[blk]["Conv_0"], p[blk]["InstanceNorm_0"]
                pre = f"{name}.{blk}"
                sd[f"{pre}.conv.weight"] = np.asarray(conv["kernel"]).transpose(conv_perm)
                sd[f"{pre}.conv.bias"] = conv["bias"]
                sd[f"{pre}.norm.weight"] = norm["scale"]
                sd[f"{pre}.norm.bias"] = norm["bias"]
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
           for k, v in sd.items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"JAX params do not fit the model: {diff[:8]}")
    return out
