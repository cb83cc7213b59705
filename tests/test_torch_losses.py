"""The port's segmentation losses (ops/losses.py) against the JAX package's
``lifelong_nnunet_tpu/ops/losses.py``: the same numpy-seeded logits (the
port channels-first, JAX channels-last) and integer targets with ``-1`` =
ignore.  f32 throughout; values to 1e-5, gradients to 1e-5 of their
scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.ops import losses as jl
from lifelong_nnunet_tpu_torch.ops import losses as tl

torch.set_num_threads(2)


def _case(seed, shape=(2, 6, 8, 5), classes=3, ignore=True):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(shape[0], classes, *shape[1:]) * 2).astype(np.float32)
    target = rng.randint(0, classes, size=shape).astype(np.int64)
    if ignore:
        target[rng.rand(*shape) < 0.2] = -1
    return logits, target


def _jax(logits):
    return jnp.asarray(np.moveaxis(logits, 1, -1))


@pytest.mark.parametrize("batch_dice", [True, False])
def test_soft_dice_loss(batch_dice):
    logits, target = _case(0)
    ref = jl.soft_dice_loss(_jax(logits), jnp.asarray(target), batch_dice)
    out = tl.soft_dice_loss(torch.from_numpy(logits), torch.from_numpy(target), batch_dice)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ignore", [True, False])
def test_cross_entropy_and_dc_ce(ignore):
    logits, target = _case(1, ignore=ignore)
    t, tt = jnp.asarray(target), torch.from_numpy(target)
    np.testing.assert_allclose(tl.cross_entropy_loss(torch.from_numpy(logits), tt).item(),
                               float(jl.cross_entropy_loss(_jax(logits), t)), rtol=1e-5)
    np.testing.assert_allclose(tl.dc_and_ce_loss(torch.from_numpy(logits), tt).item(),
                               float(jl.dc_and_ce_loss(_jax(logits), t)), rtol=1e-5)


def test_one_hot_maps_ignore_to_background():
    target = np.array([[0, 2, -1, 1]])
    out = tl.one_hot(torch.from_numpy(target), 3).numpy()
    np.testing.assert_array_equal(np.moveaxis(out, 1, -1),
                                  np.asarray(jl.one_hot(jnp.asarray(target), 3)))


@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_ds_weights(n):
    np.testing.assert_array_equal(tl.ds_weights(n), jl.ds_weights(n))
    if n >= 2:
        assert tl.ds_weights(n)[-1] == 0.0


@pytest.mark.parametrize("factor", [(1, 1, 1), (2, 2, 2), (1, 2, 1)])
def test_downsample_target(factor):
    _, target = _case(2, shape=(2, 8, 8, 6))
    np.testing.assert_array_equal(
        tl.downsample_target(torch.from_numpy(target), factor).numpy(),
        np.asarray(jl.downsample_target(jnp.asarray(target), factor)))


def test_deep_supervision_loss_and_its_gradient():
    """Four outputs at the 3d_fullres pools' factors; the coarsest has
    weight 0 and no gradient."""
    rng = np.random.RandomState(3)
    target = rng.randint(-1, 3, size=(2, 16, 16, 8)).astype(np.int64)
    factors = ((1, 1, 1), (2, 2, 2), (4, 4, 4), (8, 8, 4))
    outs = [(rng.randn(2, 3, 16 // f[0], 16 // f[1], 8 // f[2]) * 2).astype(np.float32)
            for f in factors]
    ref, grads = jax.value_and_grad(
        lambda o: jl.deep_supervision_loss(o, jnp.asarray(target), factors))(
        [_jax(o) for o in outs])
    ts = [torch.from_numpy(o).requires_grad_() for o in outs]
    loss = tl.deep_supervision_loss(ts, torch.from_numpy(target), factors)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for t, g in zip(ts[:-1], grads[:-1]):
        g = np.moveaxis(np.asarray(g), -1, 1)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()
    assert ts[-1].grad is None and not np.asarray(grads[-1]).any()


def test_online_eval_counts():
    logits, target = _case(4)
    ref = jl.online_eval_counts(_jax(logits), jnp.asarray(target), 3)
    out = tl.online_eval_counts(torch.from_numpy(logits), torch.from_numpy(target), 3)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
