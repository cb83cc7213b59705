"""The port's multi-device serving (``predict_sliding_window_sharded``)
against the JAX package's on the JAX tests' cases
(``tests/test_inference.py:272-330``), with the same tiny U-Net (the same
weights) on ``devices=["cpu"] * n`` in the port and the 8-device virtual
CPU mesh in JAX:

* 5 volumes over 8 devices (one each, padded to 8);
* 9 volumes over 4 devices with ``volume_batch=4`` (shards of 3, padded
  to 12), ``mirror_axes=(1,)``;
* volumes smaller than the patch with different original shapes that pad
  alike: each is cut back by its own undo;

segmentations equal to the port's per-volume path and to JAX's but at
near ties (f32 roundoff between XLA and PyTorch), and the
shards balanced: the padding the JAX package computes (``_shard_pad``) for
every (volumes, devices, group) and every device running the same number
of volumes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.inference import sliding_window as jsw
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.parallel.mesh import make_mesh
from lifelong_nnunet_tpu_torch.inference import sliding_window as tsw
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet

torch.set_num_threads(2)
PATCH = (16, 16, 16)


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=((2, 2, 2),),
                 conv_kernel_sizes=((3, 3, 3), (3, 3, 3)), base_num_features=4,
                 max_num_features=8)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + PATCH + (1,)))["params"])
    tm = GenericUNet(1, 3, ((2, 2, 2),), ((3, 3, 3), (3, 3, 3)), 4, 8,
                     deep_supervision=False)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return (lambda p, x: jm.apply({"params": p}, x)), params, tm.eval()


CASES = {
    "5_over_8": dict(seed=0, shapes=[(20, 20, 20)] * 5, n_dev=8, kw=dict(mirror_axes=())),
    "9_over_4_volume_batch": dict(seed=3, shapes=[(20, 20, 20)] * 9, n_dev=4,
                                  kw=dict(mirror_axes=(1,), volume_batch=4)),
    "per_volume_undo": dict(seed=1, shapes=[(12, 16, 16), (14, 15, 16), (16, 16, 10)],
                            n_dev=8, kw=dict(mirror_axes=())),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serving_matches_jax(models, case, monkeypatch):
    apply_fn, params, tm = models
    c = CASES[case]
    rng = np.random.RandomState(c["seed"])
    vols = [rng.rand(*s, 1).astype(np.float32) for s in c["shapes"]]
    want = jsw.predict_sliding_window_sharded(
        apply_fn, params, vols, PATCH, 3, mesh=make_mesh(c["n_dev"], data_parallel=c["n_dev"]),
        input_bf16=False, **c["kw"])
    shards = []
    multi = tsw.predict_sliding_window_multi

    def recording(model, volumes, *a, **kw):
        shards.append((len(volumes), kw["volume_batch"]))
        return multi(model, volumes, *a, **kw)

    monkeypatch.setattr(tsw, "predict_sliding_window_multi", recording)
    got = tsw.predict_sliding_window_sharded(tm, vols, PATCH, 3, devices=["cpu"] * c["n_dev"],
                                             input_bf16=False, **c["kw"])
    assert len(got) == len(vols)
    for g, w, v in zip(got, want, vols):
        assert g.shape == w.shape == v.shape[:-1]
        ref = tsw.predict_sliding_window(tm, v, PATCH, 3, device=torch.device("cpu"),
                                         mirror_axes=c["kw"]["mirror_axes"], output="seg")
        np.testing.assert_array_equal(g, ref)
        # JAX's: equal but where XLA's and PyTorch's f32 roundoff split a
        # near tie (the two leading probabilities within 1e-3)
        off = g != w
        assert off.mean() <= 1e-3, off.mean()
        if off.any():
            probs = tsw.predict_sliding_window(tm, v, PATCH, 3, device=torch.device("cpu"),
                                               mirror_axes=c["kw"]["mirror_axes"])
            top2 = np.sort(probs[off], axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).max() < 1e-3
    # balanced: every device one shard of the same number of whole groups
    n, n_dev = len(vols), c["n_dev"]
    vb = c["kw"].get("volume_batch", 1)
    g_size = min(vb, max(1, n // n_dev)) if vb > 1 else 1
    total = n + jsw._shard_pad(n, n_dev, g_size)
    assert len(shards) == n_dev and {s for s, _ in shards} == {total // n_dev}
    assert {b for _, b in shards} == {g_size} and (total // n_dev) % g_size == 0


def test_shard_padding_is_the_jax_packages():
    for n in range(1, 33):
        for n_dev in (1, 2, 4, 8):
            for g in (1, 2, 4):
                pad = tsw._shard_pad(n, n_dev, g)
                assert pad == jsw._shard_pad(n, n_dev, g)
                assert (n + pad) % (n_dev * g) == 0 and pad < n_dev * g


def test_volumes_that_pad_differently_are_refused(models):
    _, _, tm = models
    vols = [np.zeros((20, 20, 20, 1), np.float32), np.zeros((40, 20, 20, 1), np.float32)]
    with pytest.raises(ValueError, match="padded shape"):
        tsw.predict_sliding_window_sharded(tm, vols, PATCH, 3, devices=["cpu"] * 2)
