"""The port's volume stream (``predict_sliding_window_multi``) against the
JAX package's on the JAX test's four volumes
(``tests/test_inference.py:401-449``): two 20x24x18 volumes and a 17x23x18
one that bucket-pad alike to 24^3, and an 18x20x16 one that does not; the
same tiny U-Net (same weights), ``volume_batch=4``, ``window_batch=3``,
``mirror_axes=(1,)``, probabilities and segmentations, with and without
``input_bf16``.  The port keeps the input order, runs the three
same-bucket volumes through shared model batches and never a batch beyond
``window_batch`` x the mirror variants, and equals its own per-volume
path."""

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
PATCH = (16, 16, 16)
KW = dict(mirror_axes=(1,), window_batch=3)


class Counting(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model, self.batches = model, []

    def forward(self, x):
        self.batches.append(int(x.shape[0]))
        return self.model(x)


class MeanLogit(nn.Module):
    """Class 1's logit the input's channel mean, class 0's zero."""

    def forward(self, x):
        logit1 = x.float().mean(dim=1, keepdim=True)
        return [torch.cat([torch.zeros_like(logit1), logit1], dim=1)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=((2, 2, 2),),
                 conv_kernel_sizes=((3, 3, 3), (3, 3, 3)), base_num_features=4,
                 max_num_features=8)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + PATCH + (1,)))["params"])
    tm = GenericUNet(1, 3, ((2, 2, 2),), ((3, 3, 3), (3, 3, 3)), 4, 8,
                     deep_supervision=False)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    rng = np.random.RandomState(7)
    vols = [rng.rand(20, 24, 18, 1).astype(np.float32) for _ in range(2)]
    vols.append(rng.rand(17, 23, 18, 1).astype(np.float32))
    vols.append(rng.rand(18, 20, 16, 1).astype(np.float32))
    return (lambda p, x: jm.apply({"params": p}, x)), params, tm.eval(), vols


@pytest.mark.parametrize("input_bf16", [False, True])
@pytest.mark.parametrize("output", ["probs", "seg"])
def test_stream_matches_jax(setup, output, input_bf16):
    apply_fn, params, tm, vols = setup
    ref = jsw.predict_sliding_window_multi(apply_fn, params, vols, PATCH, 3, output=output,
                                           input_bf16=input_bf16, volume_batch=4, **KW)
    got = tsw.predict_sliding_window_multi(tm, vols, PATCH, 3, device=CPU, output=output,
                                           input_bf16=input_bf16, volume_batch=4, **KW)
    assert len(got) == len(vols)
    for g, r, v in zip(got, ref, vols):
        want = v.shape[:-1] + ((3,) if output == "probs" else ())
        assert g.shape == r.shape == want
        if output == "probs":
            np.testing.assert_allclose(g, r, atol=1e-4)
        else:
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, r)


def test_same_bucket_volumes_share_model_batches(setup):
    """24 windows of the 24^3 group in 8 batches of 3 (x 2 mirrors), then
    the last volume's 4 windows; the per-volume path would run 3 x 3 + 2."""
    _, _, tm, vols = setup
    model = Counting(tm)
    got = tsw.predict_sliding_window_multi(model, vols, PATCH, 3, device=CPU,
                                           output="probs", volume_batch=4, **KW)
    assert model.batches == [6] * 8 + [6, 2]
    assert max(model.batches) <= KW["window_batch"] * 2
    model.batches.clear()
    for g, v in zip(got, vols):
        one = tsw.predict_sliding_window(model, v, PATCH, 3, device=CPU, output="probs",
                                         input_bf16=True, **KW)
        np.testing.assert_allclose(g, one, atol=1e-6)
    assert model.batches == [6, 6, 4] * 3 + [6, 2]


@pytest.mark.parametrize("volume_batch,expect", [(1, [6, 6, 4] * 3 + [6, 2]),
                                                 (2, [6] * 5 + [2] + [6, 6, 4] + [6, 2])])
def test_groups_are_cut_at_volume_batch(setup, volume_batch, expect):
    """``volume_batch=1`` runs one volume at a time; 2 groups the first two
    and leaves the third same-bucket volume to a group of its own."""
    _, _, tm, vols = setup
    model = Counting(tm)
    tsw.predict_sliding_window_multi(model, vols, PATCH, 3, device=CPU, output="seg",
                                     volume_batch=volume_batch, **KW)
    assert model.batches == expect


def test_odd_patch_and_2d_volumes_run_alone(setup):
    """An irregular grid (odd patch, on a pool-free model whose logits are
    the input's channel mean) never groups; a 2D patch over a 3D volume
    predicts slice by slice inside the stream."""
    _, _, tm, vols = setup
    model = Counting(MeanLogit())
    odd = (15, 15, 15)
    got = tsw.predict_sliding_window_multi(model, vols[:3], odd, 2, device=CPU,
                                           output="probs", volume_batch=4, **KW)
    stream_batches = list(model.batches)
    model.batches.clear()
    for g, v in zip(got, vols[:3]):
        np.testing.assert_array_equal(g, tsw.predict_sliding_window(
            model, v, odd, 2, device=CPU, output="probs", input_bf16=True, **KW))
    assert stream_batches == model.batches
    tm2 = GenericUNet(1, 3, ((2, 2),), ((3, 3), (3, 3)), 4, 8, deep_supervision=False).eval()
    mixed = tsw.predict_sliding_window_multi(tm2, [vols[3], vols[0]], (16, 16), 3,
                                             device=CPU, output="seg", volume_batch=4, **KW)
    assert [m.shape for m in mixed] == [vols[3].shape[:-1], vols[0].shape[:-1]]


def test_unknown_output_raises(setup):
    with pytest.raises(ValueError, match="output"):
        tsw.predict_sliding_window_multi(setup[2], setup[3], PATCH, 3, device=CPU,
                                         output="logits")
