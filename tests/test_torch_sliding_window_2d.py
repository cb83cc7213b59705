"""The port's 2D-over-3D prediction (a 2D patch over a 3D volume, the
``2d`` configuration's validation and serving) against the JAX package's
``predict_sliding_window`` at its own test's shapes
(``tests/test_inference.py:500-531``): an even (16, 16) patch on a pooled
2D U-Net (the same weights in both packages) and an odd (15, 15) patch on a
pool-free model whose logits depend on the input's channel mean, over a
5 x 20 x 18 volume, 4-way TTA.  Probabilities to 1e-4, segmentations
equal, ``probs_bf16`` to 1e-2, ``input_bf16`` as JAX rounds; the port
also against its own slice-by-slice prediction, with its model batches
bounded by ``window_batch`` x the mirror variants."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.inference import sliding_window as jsw
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu_torch.inference import sliding_window as tsw
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet

torch.set_num_threads(2)
CPU = torch.device("cpu")
VOLUME = (5, 20, 18)
MIRRORS = (0, 1)


def _jax_mean_logit(params, x):
    """The pool-free model of the JAX test: class 1's logit is the input's
    channel mean times ``w``, class 0's zero."""
    logit1 = x.mean(axis=-1, keepdims=True) * params["w"]
    return [jnp.concatenate([jnp.zeros_like(logit1), logit1], axis=-1)]


class MeanLogit(nn.Module):
    """The same model in the port's layout (channels first)."""

    def __init__(self, w: float):
        super().__init__()
        self.w = w

    def forward(self, x):
        logit1 = x.float().mean(dim=1, keepdim=True) * self.w
        return [torch.cat([torch.zeros_like(logit1), logit1], dim=1)]


class Counting(nn.Module):
    """Records the batch of every forward of the wrapped model."""

    def __init__(self, model):
        super().__init__()
        self.model, self.batches = model, []

    def forward(self, x):
        self.batches.append(int(x.shape[0]))
        return self.model(x)


@pytest.fixture(scope="module")
def cases():
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=((2, 2),),
                 conv_kernel_sizes=((3, 3), (3, 3)), base_num_features=4,
                 max_num_features=8, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"])
    tm = GenericUNet(1, 3, ((2, 2),), ((3, 3), (3, 3)), 4, 8, deep_supervision=False)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return {"even": ((16, 16), (lambda p, x: jm.apply({"params": p}, x)), params,
                     tm.eval(), 3),
            "odd": ((15, 15), _jax_mean_logit, {"w": jnp.asarray(2.0)}, MeanLogit(2.0), 2)}


def _volume(seed=11):
    return np.random.RandomState(seed).rand(*VOLUME, 1).astype(np.float32)


def _both(case, data, **kw):
    patch, fn, params, tm, k = case
    ref = jsw.predict_sliding_window(fn, params, data, patch, k, mirror_axes=MIRRORS, **kw)
    got = tsw.predict_sliding_window(tm, data, patch, k, device=CPU, mirror_axes=MIRRORS,
                                     **kw)
    return got, ref


@pytest.mark.parametrize("which", ["even", "odd"])
def test_probabilities_match_jax(cases, which):
    data = _volume()
    got, ref = _both(cases[which], data)
    k = cases[which][4]
    assert got.shape == ref.shape == VOLUME + (k,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["even", "odd"])
def test_segmentation_matches_jax_off_near_ties(cases, which):
    """As ``test_torch_sliding_window.py``: the port's ``seg`` equals
    JAX's (bf16-rounded windows on the even patch's regular grid, f32 on the
    odd one's) and the argmax of its f32 probabilities wherever the top two
    are more than 1e-2 apart."""
    data = _volume(seed=12)
    seg, ref_seg = _both(cases[which], data, output="seg")
    probs, _ = _both(cases[which], data)
    assert seg.dtype == np.uint8 and seg.shape == ref_seg.shape == VOLUME
    np.testing.assert_array_equal(seg, ref_seg)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert (gap > 1e-2).mean() > 0.5
    np.testing.assert_array_equal(seg[gap > 1e-2], probs.argmax(-1)[gap > 1e-2])


@pytest.mark.parametrize("which", ["even", "odd"])
def test_probs_bf16_matches_jax(cases, which):
    got, ref = _both(cases[which], _volume(seed=13), output="probs_bf16")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-2)
    np.testing.assert_array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())


@pytest.mark.parametrize("which", ["even", "odd"])
def test_input_bf16_matches_jax(cases, which):
    """``input_bf16`` rounds the input as JAX's upload does: the port with
    it equals JAX with it, and equals the port on the rounded input."""
    data = _volume(seed=14)
    got, ref = _both(cases[which], data, input_bf16=True)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    patch, _, _, tm, k = cases[which]
    rounded = torch.from_numpy(data).bfloat16().float().numpy()
    own = tsw.predict_sliding_window(tm, rounded, patch, k, device=CPU, mirror_axes=MIRRORS)
    np.testing.assert_array_equal(got, own)


@pytest.mark.parametrize("output", ["probs", "seg"])
@pytest.mark.parametrize("which", ["even", "odd"])
def test_equals_slice_by_slice_with_bounded_batches(cases, which, output):
    """Slices are independent: the volume's result equals each slice
    predicted alone, while its model batches carry windows of several
    slices, never more than ``window_batch`` x 4 mirror variants."""
    patch, _, _, tm, k = cases[which]
    data = _volume(seed=15)
    model = Counting(tm)
    got = tsw.predict_sliding_window(model, data, patch, k, device=CPU, mirror_axes=(0, 1, 2),
                                     window_batch=3, output=output)
    per_slice = len(tsw.window_grid(VOLUME[1:], patch)[2])
    assert model.batches == [4 * min(3, VOLUME[0] * per_slice - i)
                             for i in range(0, VOLUME[0] * per_slice, 3)]
    assert per_slice % 3 != 0            # so some batches mix slices
    for d in range(VOLUME[0]):
        ref = tsw.predict_sliding_window(tm, data[d], patch, k, device=CPU,
                                         mirror_axes=(0, 1), window_batch=3, output=output)
        if output == "probs":
            np.testing.assert_allclose(got[d], ref, atol=1e-6)
        else:
            assert (got[d] == ref).mean() > 0.999


def test_mismatched_patch_raises(cases):
    with pytest.raises(ValueError, match="2D patch"):
        tsw.predict_sliding_window(cases["even"][3], np.zeros((4, 5, 6, 7, 1), np.float32),
                                   (16, 16), 3, device=CPU)
