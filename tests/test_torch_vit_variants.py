"""One train step of the port's ViT-U-Net V2 (LSA + SPT), V3 and V4, and
of the U-Net with ``remat``, against the JAX package's on the CPU, f32.

* V2 with LSA and SPT, V3 and V4 on ``tests/test_torch_vit_unet.py``'s tiny
  plan (three pools, widths 4 -> 16, a ViT of depth 2, embed 16, 2 heads,
  patch 16x32x16), flax initializing and ``models/convert.py`` carrying the
  parameters across, on the kernel route (flash attention's plain CPU
  version where no LSA) and the plain route: the loss, every gradient and
  every parameter after the PolySGD step, as that file's V1 test holds V1;
* ``remat``: the U-Net of the same plan, one train step with every stage
  recomputed in the backward against the same step without, and against
  JAX's ``GenericUNet(remat=True)`` step; each stage's forward runs twice
  in a remat step (the checkpoint's recompute), once without.

Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu.training.optimizer import make_optimizer
from lifelong_nnunet_tpu.training.train_step import (StepConfig as JaxStepConfig,
                                                     TrainState, make_train_step as jax_step)
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import ConvStage, GenericUNet
from lifelong_nnunet_tpu_torch.models.vit_unet import GenericViTUNet
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step
from tests.test_torch_vit_unet import CONVS, DS, PATCH, POOLS, VIT, _cf, _pair

torch.set_num_threads(4)

VARIANTS = {"V2_lsa_spt": ("V2", True, True), "V3": ("V3", False, False),
            "V4": ("V4", False, False)}


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    data = rng.normal(size=(2,) + PATCH + (1,)).astype(np.float32)
    seg = rng.randint(0, 3, size=(2,) + PATCH).astype(np.int8)
    return data, seg


def _jax_step(jm, params, data, seg):
    """The loss and gradients of ``jm`` at ``params``, and the parameters
    and loss of one optax step (no augmentation)."""
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_ds_loss(
        jm.apply({"params": p}, jnp.asarray(data)), jnp.asarray(seg, jnp.int32), DS,
        True)))(params)
    tx = make_optimizer(4, 2)
    step = jax_step(jm, tx, JaxStepConfig(ds_factors=DS, batch_dice=True, num_classes=3))
    state, _, metrics = step(TrainState.create(params, tx), {},
                             {"data": jnp.asarray(data), "seg": jnp.asarray(seg)},
                             jax.random.PRNGKey(0))
    return {"params": params, "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "step_loss": float(metrics["loss"]), "after": jax.tree.map(np.asarray, state.params)}


def _check_step(make, r, data, seg):
    """The port's loss to 1e-5 relative; each gradient to 1e-4 of its scale
    (a conv bias the InstanceNorm absorbs, whose gradient is 0 in exact
    arithmetic and on the fused route, to 1e-4 of its conv weight's
    gradient scale, at least 1e-6); every parameter after the clip, weight
    decay and Nesterov step to 1e-5."""
    tm = make()
    tm.load_state_dict(jax_params_to_state_dict(r["params"], tm))
    batch = {"data": _cf(data), "seg": torch.from_numpy(seg)}
    loss = deep_supervision_loss(tm(batch["data"]), batch["seg"].long(), DS, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = jax_params_to_state_dict(r["grads"], tm)
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = (g - want[name]).abs().max().item()
        scale = want[name[:-4] + "weight" if name.endswith("conv.bias") else name]
        limit = 1e-4 * scale.abs().max().item() + 1e-8
        if name.endswith("conv.bias"):
            limit = max(limit, 1e-6)
        assert err <= limit, (name, err, limit)
    tm.load_state_dict(jax_params_to_state_dict(r["params"], tm))
    opt = PolySGD(tm.parameters(), 4, 2)
    step = make_train_step(tm, opt, StepConfig(ds_factors=DS, batch_dice=True, num_classes=3))
    _, metrics = step({}, batch)
    np.testing.assert_allclose(metrics["loss"].item(), r["step_loss"], rtol=1e-5)
    want = jax_params_to_state_dict(r["after"], tm)
    for name, p in tm.named_parameters():
        assert (p.detach() - want[name]).abs().max().item() <= 1e-5, name
    return tm


@pytest.fixture(scope="module")
def variant_runs():
    """{variant: the JAX step} on the same batch."""
    data, seg = _batch()
    out = {}
    for key, (version, lsa, spt) in VARIANTS.items():
        jm, params, _, _ = _pair(version, lsa, spt)
        out[key] = _jax_step(jm, params, data, seg)
    return out, data, seg


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_train_step_matches_jax(variant_runs, variant, use_kernels):
    runs, data, seg = variant_runs
    version, lsa, spt = VARIANTS[variant]
    tm = _check_step(lambda: GenericViTUNet(1, 3, POOLS, CONVS, PATCH, 4, 16,
                                            use_kernels=use_kernels, vit_version=version,
                                            lsa=lsa, spt=spt, **VIT),
                     runs[variant], data, seg)
    # V2-V4 run the bottleneck: it trains
    assert all(p.grad is not None for p in tm.bottleneck.parameters())
    if spt:
        assert tm.vit.patch_embed_0.embed.proj.in_channels == 5 * tm.stage_features(0)
    if version == "V4":
        assert [n for n, _ in tm.named_children()].index("vit") > \
            [n for n, _ in tm.named_children()].index("dec2")


@pytest.fixture(scope="module")
def remat_run():
    """JAX's remat=True U-Net step on the tiny plan."""
    data, seg = _batch(2)
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                 base_num_features=4, max_num_features=16, remat=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(data))["params"])
    return _jax_step(jm, params, data, seg), data, seg


def _stage_calls(model):
    calls = []
    for name, m in model.named_children():
        if isinstance(m, ConvStage):
            m.register_forward_pre_hook(lambda *_, n=name: calls.append(n))
    return calls


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
def test_remat_step_matches_jax_and_the_plain_step(remat_run, use_kernels):
    """The remat step against JAX's remat step (``_check_step``'s limits);
    its loss and every gradient equal to the same step without remat
    (1e-6 of each gradient's scale: the recompute gives the same values,
    the backward may sum a skip's two gradient contributions in another
    order); each stage's forward twice per remat step, once without."""
    r, data, seg = remat_run
    tm = _check_step(lambda: GenericUNet(1, 3, POOLS, CONVS, 4, 16, use_kernels=use_kernels,
                                         remat=True), r, data, seg)
    assert tm.remat
    grads, losses, calls = {}, {}, {}
    for remat in (False, True):
        m = GenericUNet(1, 3, POOLS, CONVS, 4, 16, use_kernels=use_kernels, remat=remat)
        m.load_state_dict(jax_params_to_state_dict(r["params"], m))
        calls[remat] = _stage_calls(m)
        loss = deep_supervision_loss(m(_cf(data)), torch.from_numpy(seg).long(), DS, True)
        loss.backward()
        losses[remat] = loss.item()
        grads[remat] = {k: torch.zeros_like(p) if p.grad is None else p.grad
                        for k, p in m.named_parameters()}
    assert losses[True] == losses[False]
    for k, g in grads[False].items():
        assert (grads[True][k] - g).abs().max().item() <= 1e-6 * g.abs().max().item(), k
    stages = [n for n, m in tm.named_children() if isinstance(m, ConvStage)]
    assert sorted(calls[False]) == sorted(stages)
    assert sorted(calls[True]) == sorted(stages * 2)
    # without autograd recording (serving) nothing is recomputed
    with torch.no_grad():
        calls[True].clear()
        m(_cf(data))
    assert sorted(calls[True]) == sorted(stages)


def test_the_vit_unet_has_no_remat():
    """The JAX ViT-U-Net builds its stages without ``stage_cls``: remat is a
    no-op there, and the port's ViT-U-Net takes no remat."""
    _, _, tm, _ = _pair("V3")
    assert tm.remat is False
    with pytest.raises(TypeError):
        GenericViTUNet(1, 3, POOLS, CONVS, PATCH, 4, 16, remat=True, **VIT)
