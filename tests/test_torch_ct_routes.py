"""The CT-scale routes of the port's U-Net as a whole: the blocked conv
(``blocked_conv=True``) and the interleave upsample
(``upsample="interleave"``) against the JAX U-Net's default route on the
same parameters (the flax tree converted by ``models/convert.py``).  A
narrow 3D U-Net (widths 4 -> 16, four pools) at a 64^3 input and batch 2,
where both gates fire, in f32 on the CPU, where the routes' kernels take
their plain versions: every deep-supervision output, the loss and
gradients of one ``make_train_step`` step, the port's own direct and plain
routes beside it, the parameter tree, and which convs and levels the gates
admit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu_torch.models import unet as unet_mod
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import ConvNormAct, GenericUNet, ds_scale_factors
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step

torch.set_num_threads(4)

POOLS = ((2, 2, 2),) * 4
CONVS = ((3, 3, 3),) * 5
PATCH = (64, 64, 64)
BATCH = 2
DS = tuple(ds_scale_factors(POOLS))
# what the JAX gates admit here (unet.py:248-276, conv25d.py:391): every
# 3x3x3 conv of stride 1 or 2 with >= 16 blocks of 32 or 16 over the batch
# (64^3: 2 x 8 blocks of 32; 32^3: 2 x 8 of 16; 16^3 inputs: too few), and
# the one upsample that writes >= 2^18 voxels per item (32^3 -> 64^3)
BLOCKED = {"enc0.block0": 32, "enc0.block1": 32, "enc1.block0": 32, "enc1.block1": 16,
           "enc2.block0": 16, "dec2.block0": 16, "dec2.block1": 16, "dec3.block0": 32,
           "dec3.block1": 32}
INTERLEAVED = {3}


def _batch():
    rng = np.random.RandomState(0)
    data = rng.randn(BATCH, *PATCH, 1).astype(np.float32)
    seg = rng.randint(0, 3, size=(BATCH,) + PATCH).astype(np.int8)
    return data, seg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's parameters (initialized at a small input: they do not
    depend on its size), and its deep-supervision outputs, loss and
    gradients on the batch, on its default route."""
    model = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                    base_num_features=4, max_num_features=16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))["params"]
    data, seg = _batch()

    def loss_fn(p):
        outs = model.apply({"params": p}, jnp.asarray(data))
        return jax_ds_loss(outs, jnp.asarray(seg, jnp.int32), DS, True), outs

    (loss, outs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"params": jax.tree.map(np.asarray, params), "outs": [np.asarray(o) for o in outs],
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads), "batch": (data, seg)}


def _port(jax_run, **routes):
    model = GenericUNet(1, 3, POOLS, CONVS, 4, 16, **routes)
    model.load_state_dict(jax_params_to_state_dict(jax_run["params"], model))
    return model


def _torch_batch(jax_run):
    data, seg = jax_run["batch"]
    return {"data": torch.from_numpy(np.ascontiguousarray(np.moveaxis(data, -1, 1))),
            "seg": torch.from_numpy(seg)}


def _ct(jax_run):
    return _port(jax_run, blocked_conv=True, upsample="interleave")


def test_parameter_tree_is_unchanged(jax_run):
    """The routes change no parameter: the same names and shapes as the
    direct route, and the converted JAX tree loads strictly."""
    ct, direct = _ct(jax_run), _port(jax_run)
    assert [(k, v.shape) for k, v in ct.state_dict().items()] == \
        [(k, v.shape) for k, v in direct.state_dict().items()]
    with pytest.raises(ValueError, match="upsample"):
        GenericUNet(1, 3, POOLS, CONVS, 4, 16, upsample="pallas")


def test_gates_admit_the_predicted_convs_and_levels(jax_run, monkeypatch):
    """Each ConvNormAct's route at the batch's shapes, and one forward that
    runs exactly that many blocked convs and interleaves; with the switches
    off, or on the plain route, none."""
    calls = {"blocked": [], "interleave": 0}
    real_packed, real_up = unet_mod.packed_conv_in_lrelu, unet_mod.conv_transpose3d_interleave

    def packed(*a, **k):
        calls["blocked"].append(k["bs"])
        return real_packed(*a, **k)

    def up(*a, **k):
        calls["interleave"] += 1
        return real_up(*a, **k)

    monkeypatch.setattr(unet_mod, "packed_conv_in_lrelu", packed)
    monkeypatch.setattr(unet_mod, "conv_transpose3d_interleave", up)
    for routes, use_kernels, blocked, interleaved in (
            (dict(blocked_conv=True, upsample="interleave"), True, BLOCKED, INTERLEAVED),
            ({}, True, {}, set()),
            (dict(blocked_conv=True, upsample="interleave"), False, {}, set())):
        model = GenericUNet(1, 3, POOLS, CONVS, 4, 16, use_kernels=use_kernels, **routes)
        seen = {}
        hooks = [m.register_forward_pre_hook(
            lambda m, inp, name=name: seen.__setitem__(name, m.packed_bs(inp[0].shape)))
            for name, m in model.named_modules() if isinstance(m, ConvNormAct)]
        calls["blocked"], calls["interleave"] = [], 0
        with torch.no_grad():
            model(_torch_batch(jax_run)["data"])
        for h in hooks:
            h.remove()
        ups = {d for d in range(4) if model.interleaved(
            d, (BATCH, model.stage_features(4 - d)) + tuple(s // 2 ** (4 - d) for s in PATCH))}
        assert {k: v for k, v in seen.items() if v is not None} == blocked
        assert sorted(calls["blocked"]) == sorted(blocked.values())
        assert ups == interleaved and calls["interleave"] == len(interleaved)
    # the gate counts blocks over the batch: at 32^3, 1 x 8 blocks of 16 are
    # too few, 2 x 8 enough
    m = GenericUNet(1, 3, POOLS, CONVS, 4, 16, blocked_conv=True).enc1.block1
    assert m.packed_bs((1, 16, 32, 32, 32)) is None and m.packed_bs((2, 16, 32, 32, 32)) == 16


def test_deep_supervision_outputs_match_jax(jax_run):
    """f32, atol 2e-4 + rtol 1e-3, as tests/test_torch_unet.py (cuDNN-free
    summation orders on both sides)."""
    with torch.no_grad():
        outs = _ct(jax_run).eval()(_torch_batch(jax_run)["data"])
    assert len(outs) == len(jax_run["outs"]) == 4
    for i, (o, jo) in enumerate(zip(outs, jax_run["outs"])):
        np.testing.assert_allclose(np.moveaxis(o.numpy(), 1, -1), jo, atol=2e-4, rtol=1e-3,
                                   err_msg=f"DS output {i}")


@pytest.mark.parametrize("route", ["ct", "direct", "plain"])
def test_train_step_loss_and_gradients_match_jax(jax_run, route):
    """One ``make_train_step`` step (no augmentation), its loss and the
    gradients it applies, on the CT routes and, beside them, the port's
    direct and plain routes.  The loss to 1e-5 relative; each gradient to
    5e-3 of its scale: at 64^3 in f32 the summation order alone moves the
    gradients by ~2e-3 of their scale on every route, the direct and plain
    ones included.  The biases of the blocked and fused convs, which the
    InstanceNorm absorbs, get 0 (and the JAX package's roundoff of 0 stays
    within 1e-4 of the weight's gradient scale)."""
    routes = dict(blocked_conv=True, upsample="interleave") if route == "ct" else {}
    model = _port(jax_run, use_kernels=route != "plain", **routes)
    taken, grads = {}, {}
    for name, m in model.named_modules():
        if isinstance(m, ConvNormAct):
            m.register_forward_pre_hook(
                lambda m, inp, name=name: taken.__setitem__(name, m.route(inp[0].shape)))

    def capture(cl_state, model, loss):
        grads.update((n, torch.zeros_like(p) if p.grad is None else p.grad.clone())
                     for n, p in model.named_parameters())
        return cl_state

    opt = PolySGD(model.parameters(), 2, 2)
    step = make_train_step(model, opt, StepConfig(ds_factors=DS, batch_dice=True,
                                                  num_classes=3), cl_state_update=capture)
    _, metrics = step({}, _torch_batch(jax_run))
    np.testing.assert_allclose(metrics["loss"].item(), jax_run["loss"], rtol=1e-5)
    assert sum(r == "blocked" for r in taken.values()) == {"ct": 9}.get(route, 0)
    want = jax_params_to_state_dict(jax_run["grads"], model)
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        block = name.rsplit(".", 2)[0]
        if name.endswith("conv.bias") and taken.get(block) in ("blocked", "fused"):
            assert not g.any(), name
            assert scale <= 1e-4 * want[name[:-4] + "weight"].abs().max().item(), name
        elif not name.endswith("conv.bias"):
            err = (g - want[name]).abs().max().item()
            assert err <= 5e-3 * scale + 1e-8, (name, err)
