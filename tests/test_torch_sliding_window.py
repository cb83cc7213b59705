"""The port's sliding-window inference
(lifelong_nnunet_tpu_torch/inference/sliding_window.py) against the JAX
package's: the grid arithmetic must be identical, and the Gaussian-weighted,
mirror-TTA probabilities of the same tiny U-Net (same weights) must agree
on the CPU in float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.inference import sliding_window as jsw
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu_torch.inference import sliding_window as tsw
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet

torch.set_num_threads(2)
CPU = torch.device("cpu")
POOLS, KERNELS, PATCH = ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3, (16, 16, 16)


@pytest.mark.parametrize("image,patch,step", [
    ((40, 50, 60), (16, 16, 16), 0.5), ((16, 30, 17), (16, 16, 16), 0.5),
    ((100, 37, 9), (32, 20, 8), 0.5), ((64, 64, 64), (20, 24, 28), 0.7),
    ((10, 10, 10), (16, 16, 16), 0.5)])
def test_grid_arithmetic_identical(image, patch, step):
    assert tsw.compute_steps(image, patch, step) == jsw.compute_steps(image, patch, step)
    assert tsw.bucket_shape(image, patch, step) == jsw.bucket_shape(image, patch, step)
    pads, undo, origins = tsw.window_grid(image, patch, step)
    jpads, jundo, jorigins, _, _, grid = jsw._prepare_meta(image, patch, step, 4, True)
    assert pads == jpads[:-1] and undo == jundo
    if grid is None:
        jorigins = jorigins[0][jorigins[1] > 0]
    else:
        jorigins = np.array(np.meshgrid(*[np.arange(n) * (p // 2) for n, p
                                          in zip(grid, patch)], indexing="ij"))
        jorigins = jorigins.reshape(len(patch), -1).T
    assert [tuple(o) for o in jorigins] == origins
    data = np.zeros(image + (1,), np.float32)
    a, sl = tsw.pad_to_min(data, patch)
    b, jsl = jsw.pad_to_min(data, patch)
    assert a.shape == b.shape and sl == jsl


@pytest.mark.parametrize("patch", [(16, 16, 16), (32, 20, 8), (15, 9, 7)])
def test_gaussian_importance_map_identical(patch):
    np.testing.assert_array_equal(tsw.gaussian_importance_map(patch),
                                  jsw.gaussian_importance_map(patch))


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS,
                 conv_kernel_sizes=KERNELS, base_num_features=4,
                 max_num_features=8, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1,) + PATCH + (1,)))["params"]
    tm = GenericUNet(1, 3, POOLS, KERNELS, 4, 8, deep_supervision=False)
    tm.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return (lambda p, x: jm.apply({"params": p}, x)), params, tm.eval()


def _volume(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.normal(size=shape + (1,)).astype(np.float32)


@pytest.mark.parametrize("shape,step", [((20, 28, 18), 0.5), ((12, 24, 20), 0.5),
                                        ((20, 22, 18), 0.7)])
def test_probabilities_match_jax(models, shape, step):
    apply_fn, params, tm = models
    data = _volume(shape)
    ref = jsw.predict_sliding_window(apply_fn, params, data, PATCH, 3,
                                     step_fraction=step, window_batch=4)
    out = tsw.predict_sliding_window(tm, data, PATCH, 3, device=CPU,
                                     step_fraction=step, window_batch=4)
    assert out.shape == ref.shape == shape + (3,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_segmentation_matches_jax_off_near_ties(models):
    """``output='seg'`` sums bf16-rounded window probabilities in f32, as
    the JAX package's overlap-add cores do, and equals JAX's ``seg``.  It
    equals the argmax of either package's f32 probabilities wherever the
    top two are more than 1e-2 apart (a few bf16 roundings of values below
    1)."""
    apply_fn, params, tm = models
    data = _volume((20, 28, 18), seed=1)
    probs = tsw.predict_sliding_window(tm, data, PATCH, 3, device=CPU)
    seg = tsw.predict_sliding_window(tm, data, PATCH, 3, device=CPU, output="seg")
    ref_probs = jsw.predict_sliding_window(apply_fn, params, data, PATCH, 3)
    ref_seg = jsw.predict_sliding_window(apply_fn, params, data, PATCH, 3,
                                         output="seg")
    assert seg.dtype == np.uint8 and seg.shape == ref_seg.shape == data.shape[:-1]
    np.testing.assert_array_equal(seg, ref_seg)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert (gap > 1e-2).mean() > 0.9
    np.testing.assert_array_equal(seg[gap > 1e-2], probs.argmax(-1)[gap > 1e-2])
    np.testing.assert_array_equal(seg[gap > 1e-2], ref_probs.argmax(-1)[gap > 1e-2])


def test_probs_bf16_and_no_tta(models):
    apply_fn, params, tm = models
    data = _volume((16, 16, 16), seed=2)
    kw = dict(mirror_axes=(), window_batch=2)
    out = tsw.predict_sliding_window(tm, data, PATCH, 3, device=CPU,
                                     output="probs_bf16", **kw)
    ref = jsw.predict_sliding_window(apply_fn, params, data, PATCH, 3,
                                     output="probs_bf16", **kw)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-2)
    bf16 = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(out, bf16)


def test_tta_mean_uses_every_mirror_combo(models):
    *_, tm = models
    assert len(tsw.mirror_combos((0, 1, 2))) == 8
    x = torch.from_numpy(_volume((16, 16, 16), 3)).permute(3, 0, 1, 2)[None]
    with torch.no_grad():
        mean = tsw.tta_softmax(tm, x, (0, 1, 2))
        ref = sum(torch.softmax(tm(x.flip(f))[0].flip(f), 1) if f else
                  torch.softmax(tm(x)[0], 1)
                  for f in [[a + 2 for a in c] for c in tsw.mirror_combos((0, 1, 2))]) / 8
    torch.testing.assert_close(mean, ref, atol=1e-6, rtol=1e-5)
