"""The port's train step (training/train_step.py with the PolySGD chain of
training/optimizer.py) against the JAX package's ``make_train_step`` with
its optax chain: the same U-Net (widths 4 -> 16, two pools, deep
supervision), the same initial parameters (the flax tree converted by
``models/convert.py``), the same numpy-seeded batches, f32 on the CPU and
no augmentation.  The loss and every gradient of the first step, and every
parameter after 1 and 3 steps, on the kernel route (the ``autograd.Function``s'
plain CPU versions) and on the plain route.  ``jax_params_to_state_dict``
is linear in the leaves, so it maps the JAX gradient tree onto the port's
parameter names too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu.training.optimizer import make_optimizer
from lifelong_nnunet_tpu.training.train_step import (StepConfig as JaxStepConfig,
                                                     TrainState, make_train_step as jax_step)
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet, ds_scale_factors
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step

torch.set_num_threads(4)

POOLS = ((2, 2, 2), (2, 2, 2))
CONVS = ((3, 3, 3),) * 3
PATCH = (16, 16, 16)
BATCH = 2
MAX_EPOCHS, ITERS = 4, 2          # the poly LR drops after step 2
DS = tuple(ds_scale_factors(POOLS))


def _batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        data = rng.randn(BATCH, *PATCH, 1).astype(np.float32)
        seg = rng.randint(0, 3, size=(BATCH,) + PATCH).astype(np.int8)
        seg[:, :2] = -1                                   # padding: ignored
        out.append((data, seg))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Initial parameters, the first step's loss and gradients, and the
    parameters after 1 and 3 steps of the JAX package."""
    model = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                    base_num_features=4, max_num_features=16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1,) + PATCH + (1,)))["params"]
    batches = _batches(3)
    data, seg = (jnp.asarray(a) for a in batches[0])
    loss, grads = jax.value_and_grad(lambda p: jax_ds_loss(
        model.apply({"params": p}, data), seg.astype(jnp.int32), DS, True))(params)
    tx = make_optimizer(MAX_EPOCHS, ITERS)
    step = jax_step(model, tx, JaxStepConfig(ds_factors=DS, batch_dice=True, num_classes=3))
    state, after = TrainState.create(params, tx), {}
    losses = []
    for i, (d, s) in enumerate(batches):
        state, _, metrics = step(state, {}, {"data": jnp.asarray(d), "seg": jnp.asarray(s)},
                                 jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
        after[i + 1] = jax.tree.map(np.asarray, state.params)
    return {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "after": after, "losses": losses,
            "batches": batches}


def _port_model(jax_run, use_kernels):
    model = GenericUNet(1, 3, POOLS, CONVS, 4, 16, use_kernels=use_kernels)
    model.load_state_dict(jax_params_to_state_dict(jax_run["params"], model))
    return model


def _torch_batch(data, seg):
    return {"data": torch.from_numpy(np.ascontiguousarray(np.moveaxis(data, -1, 1))),
            "seg": torch.from_numpy(seg)}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
def test_first_step_loss_and_gradients(jax_run, use_kernels):
    """Loss to 1e-5 relative; each gradient to 1e-4 of its scale (XLA's and
    PyTorch's f32 convs sum in different orders); the conv biases, which
    the InstanceNorm absorbs, to 1e-6 absolutely (0 on the kernel route)."""
    model = _port_model(jax_run, use_kernels)
    b = _torch_batch(*jax_run["batches"][0])
    loss = deep_supervision_loss(model(b["data"]), b["seg"].long(), DS, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    want = jax_params_to_state_dict(jax_run["grads"], model)
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = (g - want[name]).abs().max().item()
        if name.endswith("conv.bias"):
            assert err <= 1e-6, name
        else:
            assert err <= 1e-4 * want[name].abs().max().item() + 1e-8, (name, err)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
def test_parameters_after_sgd_steps(jax_run, use_kernels, steps):
    """Clip, weight decay, Nesterov momentum and the poly LR as the optax
    chain: losses to 1e-5 relative, every parameter to 1e-5 absolutely."""
    model = _port_model(jax_run, use_kernels)
    opt = PolySGD(model.parameters(), MAX_EPOCHS, ITERS)
    step = make_train_step(model, opt, StepConfig(ds_factors=DS, batch_dice=True,
                                                  num_classes=3))
    for i in range(steps):
        _, metrics = step({}, _torch_batch(*jax_run["batches"][i]))
        np.testing.assert_allclose(metrics["loss"].item(), jax_run["losses"][i], rtol=1e-5)
    assert opt.step_count == steps and opt.lr() == pytest.approx(
        1e-2 * (1 - (steps // ITERS) / MAX_EPOCHS) ** 0.9)
    want = jax_params_to_state_dict(jax_run["after"][steps], model)
    for name, p in model.named_parameters():
        err = (p.detach() - want[name]).abs().max().item()
        assert err <= 1e-5, (name, err)
