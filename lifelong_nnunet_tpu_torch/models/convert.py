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

:func:`jax_cl_state_to_torch` carries a JAX continual-learning state
(EWC's ``{"ewc_tasks": ...}`` or RW's ``{"running", "anchor", "score_sets",
...}``, dicts keyed by flax paths ``enc0/block0/Conv_0/kernel``) over to
the port's ``state_dict`` keys, each fisher, score and anchor permuted as
the parameter it belongs to.
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


def _with_leaves(params, leaves) -> dict:
    """The nested tree of ``params`` with its leaves, in :func:`_flatten`'s
    order, replaced by ``leaves``."""
    tree = {}
    for (path, _), leaf in zip(_flatten(params), leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def jax_key_map(params, model: GenericUNet) -> dict:
    """{port key: flax path "a/b/c"}: each leaf of ``params`` filled with
    its own index goes through :func:`jax_params_to_state_dict`."""
    flat = list(_flatten(params))
    marked = _with_leaves(params, [np.full(np.shape(v), i, np.float32)
                                   for i, (_, v) in enumerate(flat)])
    return {k: "/".join(flat[int(v.reshape(-1)[0])][0])
            for k, v in jax_params_to_state_dict(marked, model).items()}


def _convert_flat(flat: Mapping, params, model: GenericUNet, key_map: dict) -> dict:
    """A flat {flax path: array} over some of the parameters -> {port key:
    tensor} over the same ones, in the array's dtype (bf16 stays bf16)."""
    leaves = [np.asarray(flat["/".join(path)], np.float32) if "/".join(path) in flat
              else np.zeros(np.shape(value), np.float32) for path, value in _flatten(params)]
    out = jax_params_to_state_dict(_with_leaves(params, leaves), model)
    bf16 = {name for name, v in flat.items() if str(np.asarray(v).dtype) == "bfloat16"}
    return {k: out[k].to(torch.bfloat16) if path in bf16 else out[k]
            for k, path in key_map.items() if path in flat}


def jax_cl_state_to_torch(cl_state: Mapping, params, model: GenericUNet) -> dict:
    """``cl_state``: a JAX EWC (``{"ewc_tasks": {task: {"fisher",
    "params"}}}``) or RW (``{"running": {"fisher", "scores", "prev_params",
    "prev_loss", "iter"} or None, "anchor": {"fisher", "scores", "params"} or
    None, "score_sets": [...], "num_tasks_done"}``) state of numpy or jax
    arrays; ``params``: the JAX model's parameter tree.  Returns the port
    trainer's ``cl_state`` (CPU tensors; scalars as 0-d tensors, counters as
    ints)."""
    key_map = jax_key_map(params, model)

    def conv(flat):
        return _convert_flat(flat, params, model, key_map)

    if "ewc_tasks" in cl_state:
        return {"ewc_tasks": {t: {"fisher": conv(s["fisher"]), "params": conv(s["params"])}
                              for t, s in cl_state["ewc_tasks"].items()}}
    r, a = cl_state.get("running"), cl_state.get("anchor")
    sets = cl_state.get("score_sets") or []
    if isinstance(sets, Mapping):        # a msgpack round trip keys a list by index
        sets = [sets[k] for k in sorted(sets, key=int)]
    return {
        "running": None if r is None else {
            "fisher": conv(r["fisher"]), "scores": conv(r["scores"]),
            "prev_params": conv(r["prev_params"]),
            "prev_loss": torch.tensor(float(np.asarray(r["prev_loss"])), dtype=torch.float32),
            "iter": int(np.asarray(r["iter"]))},
        "anchor": None if a is None else {k: conv(a[k]) for k in ("fisher", "scores", "params")},
        "score_sets": [conv(s) for s in sets],
        "num_tasks_done": int(np.asarray(cl_state.get("num_tasks_done", len(sets)))),
    }
