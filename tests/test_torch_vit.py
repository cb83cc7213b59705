"""The port's ViT modules (lifelong_nnunet_tpu_torch/models/vit.py) against
the JAX package's (lifelong_nnunet_tpu/models/vit.py): flax initializes,
``models/convert.py`` carries the parameters across, and numpy-seeded
inputs go through both on the CPU.  PatchEmbed, SPT, TaskLayerNorm, Block
(with and without LSA, both attention routes) and the VisionTransformer
with its per-block attention weights; then the JAX-style linear resize
(``jax.image.resize(..., "linear")``, antialiased when it shrinks) that
the ViT-U-Net applies to the ViT's grid, with ``F.interpolate`` as the
control that misses it.  f32 unless a test says otherwise; each tolerance
is stated where it is used."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.models import vit as jvit
from lifelong_nnunet_tpu_torch.models import vit as tvit
from lifelong_nnunet_tpu_torch.models.convert import _vit_entries
from lifelong_nnunet_tpu_torch.models.vit_unet import linear_resize

torch.set_num_threads(2)
GEN = torch.Generator().manual_seed(0)
CONV_PERM = (4, 3, 0, 1, 2)


def _init(module, *args, **kw):
    params = module.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _load(port, params, scope):
    """Load the flax subtree ``params`` of a module named ``scope`` into the
    port module ``port``, through the converter's ViT mapping."""
    pre = f"vit.{scope}."
    sd = {k[len(pre):]: torch.tensor(v) for k, v in
          _vit_entries({scope: params}, CONV_PERM).items()}
    port.load_state_dict(sd)
    return port


def _cf(x):
    """channels-last numpy -> channels-first tensor"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _x(shape, seed=0, offset=0.0):
    return (np.random.RandomState(seed).normal(size=shape) + offset).astype(np.float32)


@pytest.mark.parametrize("spt", [False, True], ids=["patch_embed", "spt"])
def test_patch_embedding_matches_jax(spt):
    """Tokens of a (16, 24, 16) input, 3 channels, patch 8, embed 16, in the
    grid's row-major order, to 1e-5."""
    x = _x((2, 16, 24, 16, 3))
    cls_j = jvit.ShiftedPatchTokenization if spt else jvit.PatchEmbed
    jm = cls_j((8, 8, 8), 16)
    params = _init(jm, jnp.asarray(x))
    (j_tokens, j_grid) = jm.apply({"params": params}, jnp.asarray(x))
    cls_t = tvit.ShiftedPatchTokenization if spt else tvit.PatchEmbed
    tm = _load(cls_t(3, (8, 8, 8), 16, GEN), params, "patch_embed_0")
    with torch.no_grad():
        tokens, grid = tm(_cf(x), torch.float32)
    assert grid == tuple(j_grid) == (2, 3, 2)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(j_tokens), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_task_layer_norm_matches_jax(dtype):
    """flax LayerNorm (eps 1e-6, one-pass f32 statistics, output in the
    compute dtype) on rows with a large mean: f32 to 1e-5; bf16 within one
    bf16 rounding (8e-3 relative)."""
    x = _x((2, 10, 32), offset=3.0) * 2
    jm = jvit.TaskLayerNorm(dtype=dtype)
    params = _init(jm, jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * np.arange(a.size).reshape(a.shape)
                                    / a.size, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    tm = _load(tvit.TaskLayerNorm(32), params, "norm")
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tdt)
    assert got.dtype == tdt
    rtol = 1e-5 if dtype == jnp.float32 else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("lsa", [False, True], ids=["no_lsa", "lsa"])
def test_block_matches_jax(lsa, use_kernels):
    """One pre-norm block (LN, attention, residual, tanh-GELU MLP) on 70
    tokens of width 32, 2 heads: output to 2e-5 + 1e-4 relative."""
    x = _x((2, 70, 32), seed=1)
    jm = jvit.Block(num_heads=2, lsa=lsa)
    params = _init(jm, jnp.asarray(x))
    j_out, _ = jm.apply({"params": params}, jnp.asarray(x), need_weights=False)
    tm = _load(tvit.Block(32, 2, 4, lsa, use_kernels, GEN), params, "block0")
    with torch.no_grad():
        out, w = tm(torch.from_numpy(x), torch.float32)
    assert w is None or lsa or not use_kernels
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5, rtol=1e-4)


def _vit_pair(lsa=False, spt=False, use_kernels=True):
    x = _x((2, 16, 24, 16, 4), seed=2)
    jm = jvit.VisionTransformer(out_features=(8,), embed_dim=32, depth=2, num_heads=2,
                                lsa=lsa, spt=spt)
    params = _init(jm, jnp.asarray(x))
    tm = tvit.VisionTransformer([(4, 16, 24, 16)], [8], embed_dim=32, depth=2, num_heads=2,
                                lsa=lsa, spt=spt, use_kernels=use_kernels)
    sd = {k[len("vit."):]: torch.tensor(v) for k, v in _vit_entries(params, CONV_PERM).items()}
    tm.load_state_dict(sd)
    return jm, params, tm, x


@pytest.mark.parametrize("lsa,spt", [(False, False), (True, True)], ids=["plain", "lsa_spt"])
def test_vision_transformer_with_attention_weights_matches_jax(lsa, spt):
    """``return_attn``: the per-token output [B, C, *grid] to 2e-5 + 1e-4
    relative and each block's weights [B, H, N, N] to 1e-6."""
    jm, params, tm, x = _vit_pair(lsa, spt)
    j_out, j_attn = jm.apply({"params": params}, jnp.asarray(x), return_attn=True)
    with torch.no_grad():
        out, attn = tm(_cf(x), return_attn=True)
    assert out.shape == (2, 8, 2, 3, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(j_out),
                               atol=2e-5, rtol=1e-4)
    assert len(attn) == len(j_attn) == 2
    for a, ja in zip(attn, j_attn):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
def test_vision_transformer_gradients_match_jax(use_kernels):
    """Without weights the kernel route runs flash attention: output and
    every parameter's gradient of sum(out * g), to 1e-4 of each
    gradient's scale."""
    jm, params, tm, x = _vit_pair(use_kernels=use_kernels)
    g = _x((2, 2, 3, 2, 8), seed=3)
    j_grads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x))
                                         * jnp.asarray(g)))(params)
    want = {k[len("vit."):]: v for k, v in _vit_entries(j_grads, CONV_PERM).items()}
    out = tm(_cf(x))
    (out * _cf(g)).sum().backward()
    for name, p in tm.named_parameters():
        ref = want[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7, (name, err)


def test_vision_transformer_in_bf16_follows_jax():
    """bf16 compute with f32 parameters and an f32 residual stream, as flax
    runs it: within 3e-2 of the output's scale (bf16 rounds at other
    places in the two frameworks)."""
    jm, params, tm, x = _vit_pair()
    jm = jm.clone(dtype=jnp.bfloat16)
    j_out = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(_cf(x).to(torch.bfloat16))
    assert out.dtype == torch.float32
    err = np.abs(np.moveaxis(out.numpy(), 1, -1) - j_out).max()
    assert err <= 3e-2 * np.abs(j_out).max(), err


RESIZES = [((7, 10, 7), (7, 5, 7)), ((4, 6, 4), (8, 12, 8)), ((2, 3, 2), (16, 24, 16))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=["shrink_h", "grow_2x", "grow_8x"])
def test_linear_resize_matches_jax_image_resize(src, dst):
    """Channels-first ``linear_resize`` against ``jax.image.resize(...,
    "linear")`` on channels-last data, to 2e-6."""
    x = _x((2,) + src + (5,), seed=4)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst + (5,), method="linear"))
    got = linear_resize(_cf(x), dst)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, atol=2e-6)


def test_trilinear_interpolate_is_not_the_jax_resize():
    """The control: ``F.interpolate`` (no antialiasing) misses the V1
    resize of the 7x10x7 token grid to the 7x5x7 bottleneck by > 0.1."""
    x = _x((2, 7, 10, 7, 5), seed=4)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 7, 5, 7, 5), method="linear"))
    ctrl = F.interpolate(_cf(x), size=(7, 5, 7), mode="trilinear", align_corners=False)
    assert np.abs(np.moveaxis(ctrl.numpy(), 1, -1) - want).max() > 0.1
