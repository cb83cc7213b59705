"""The port's ViT-U-Net (lifelong_nnunet_tpu_torch/models/vit_unet.py)
against the JAX package's ``GenericViTUNet`` on the CPU, f32: a tiny plan
(three pools, one of them anisotropic so the V1 resize shrinks one axis;
widths 4 -> 16; a ViT of depth 2, embed 16, 2 heads; patch 16x32x16), flax
initializes and ``models/convert.py`` carries the parameters across.

* V1-V4 deep-supervision outputs, on the kernel route (flash attention's
  plain CPU version) and the plain route; LSA + SPT on V1;
* ``module_order()`` and the registration order equal JAX's;
* one V1 train step (loss, every gradient, every parameter after the
  PolySGD step) against JAX's ``make_train_step`` with its optax chain;
* end to end through the entry points: ``nnUNet_torch_train_vit ...
  --device cpu`` trains a tiny V1, ``nnUNet_torch_inference
  nnViTUNetTrainer --use_vit --device cpu`` serves what it wrote.

Each tolerance is stated where it is used."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.models.vit_unet import GenericViTUNet as JaxViTUNet
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu.training.optimizer import make_optimizer
from lifelong_nnunet_tpu.training.train_step import (StepConfig as JaxStepConfig,
                                                     TrainState, make_train_step as jax_step)
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import ds_scale_factors
from lifelong_nnunet_tpu_torch.models.vit_unet import GenericViTUNet
from lifelong_nnunet_tpu_torch.ops.kernels.attention import flash_attention
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training_vit import run_training_vit
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.restore import restore_model
from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image

torch.set_num_threads(4)

POOLS = ((2, 2, 2), (2, 2, 2), (1, 2, 1))
CONVS = ((3, 3, 3),) * 4
PATCH = (16, 32, 16)
VIT = dict(vit_embed_dim=16, vit_depth=2, vit_heads=2)
DS = tuple(ds_scale_factors(POOLS))
TASK = "Task097_SynthA"


def _pair(version, lsa=False, spt=False, use_kernels=True, batch=2):
    jm = JaxViTUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                    base_num_features=4, max_num_features=16, vit_version=version,
                    lsa=lsa, spt=spt, **VIT)
    x = np.random.RandomState(0).normal(size=(batch,) + PATCH + (1,)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = GenericViTUNet(1, 3, POOLS, CONVS, PATCH, 4, 16, use_kernels=use_kernels,
                        vit_version=version, lsa=lsa, spt=spt, **VIT)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return jm, params, tm, x


def _cf(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


CASES = [("V1", False, False), ("V2", False, False), ("V3", False, False),
         ("V4", False, False), ("V1", True, True)]


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("version,lsa,spt", CASES,
                         ids=["V1", "V2", "V3", "V4", "V1_lsa_spt"])
def test_outputs_match_jax(version, lsa, spt, use_kernels):
    """Every deep-supervision output to 1e-4 + 1e-3 relative (as the U-Net's
    parity test: XLA's and PyTorch's f32 convs sum in other orders)."""
    jm, params, tm, x = _pair(version, lsa, spt, use_kernels)
    j_outs = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        outs = tm(_cf(x))
    assert len(outs) == len(j_outs) == len(POOLS)
    for i, (o, jo) in enumerate(zip(outs, j_outs)):
        np.testing.assert_allclose(np.moveaxis(o.numpy(), 1, -1), np.asarray(jo),
                                   atol=1e-4, rtol=1e-3, err_msg=f"DS output {i}")


@pytest.mark.parametrize("version", ["V1", "V2", "V3", "V4"])
def test_module_order_matches_jax(version):
    jm, params, tm, _ = _pair(version)
    assert tm.module_order() == jm.module_order()
    assert [n for n, _ in tm.named_children()] == jm.module_order()
    assert sorted(params) == sorted(jm.module_order())
    assert tm.module_order().index("vit") == (4 if version != "V4" else 10)


def test_v1_does_not_run_the_bottleneck():
    """V1 replaces the bottleneck's output: the port skips the stage, its
    parameters get no gradient (PolySGD zero-fills them), and the flash
    wrapper runs once per block (counted only on the card)."""
    _, _, tm, x = _pair("V1")
    seen = []
    tm.bottleneck.register_forward_hook(lambda *a: seen.append(1))
    deep_supervision_loss(tm(_cf(x)), torch.zeros((2,) + PATCH, dtype=torch.long),
                          DS).backward()
    assert not seen and all(p.grad is None for p in tm.bottleneck.parameters())
    assert all(p.grad is not None for p in tm.vit.parameters())
    assert flash_attention.launches == 0


@pytest.fixture(scope="module")
def jax_step_run():
    """V1: initial parameters, the first step's loss and gradients, and the
    parameters after one optax step (no augmentation)."""
    jm, params, _, _ = _pair("V1")
    rng = np.random.RandomState(1)
    data = rng.normal(size=(2,) + PATCH + (1,)).astype(np.float32)
    seg = rng.randint(0, 3, size=(2,) + PATCH).astype(np.int8)
    loss, grads = jax.value_and_grad(lambda p: jax_ds_loss(
        jm.apply({"params": p}, jnp.asarray(data)), jnp.asarray(seg, jnp.int32), DS,
        True))(params)
    tx = make_optimizer(4, 2)
    step = jax_step(jm, tx, JaxStepConfig(ds_factors=DS, batch_dice=True, num_classes=3))
    state, _, metrics = step(TrainState.create(params, tx), {},
                             {"data": jnp.asarray(data), "seg": jnp.asarray(seg)},
                             jax.random.PRNGKey(0))
    return {"params": params, "data": data, "seg": seg, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "step_loss": float(metrics["loss"]),
            "after": jax.tree.map(np.asarray, state.params)}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
def test_v1_train_step_matches_jax(jax_step_run, use_kernels):
    """Loss to 1e-5 relative; each gradient to 1e-4 of its scale (1e-6
    absolute for the InstanceNorm-absorbed conv biases and the dead
    bottleneck, 0 on the port); every parameter after the clip, weight
    decay and Nesterov step to 1e-5."""
    r = jax_step_run
    tm = GenericViTUNet(1, 3, POOLS, CONVS, PATCH, 4, 16, use_kernels=use_kernels, **VIT)
    tm.load_state_dict(jax_params_to_state_dict(r["params"], tm))
    batch = {"data": _cf(r["data"]), "seg": torch.from_numpy(r["seg"])}
    loss = deep_supervision_loss(tm(batch["data"]), batch["seg"].long(), DS, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    want = jax_params_to_state_dict(r["grads"], tm)
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = (g - want[name]).abs().max().item()
        if name.endswith("conv.bias") or name.startswith("bottleneck"):
            assert err <= 1e-6, (name, err)
        else:
            assert err <= 1e-4 * want[name].abs().max().item() + 1e-8, (name, err)

    tm.load_state_dict(jax_params_to_state_dict(r["params"], tm))
    opt = PolySGD(tm.parameters(), 4, 2)
    step = make_train_step(tm, opt, StepConfig(ds_factors=DS, batch_dice=True, num_classes=3))
    _, metrics = step({}, batch)
    np.testing.assert_allclose(metrics["loss"].item(), r["step_loss"], rtol=1e-5)
    want = jax_params_to_state_dict(r["after"], tm)
    for name, p in tm.named_parameters():
        assert (p.detach() - want[name]).abs().max().item() <= 1e-5, name


def test_train_then_serve_through_the_entry_points(synthetic_task, tmp_path, monkeypatch):
    """``nnUNet_torch_train_vit 3d_fullres <task> 0`` trains a tiny V1 ViT-U-Net
    (widths 4 -> 16, ``-vit_depth 1``) for 2 epochs of 2 steps at the plan's
    patch and half its batch, and ``nnUNet_torch_inference nnViTUNetTrainer
    --use_vit`` restores the ViT-U-Net from the manifest and segments the
    task's images."""
    pre = tmp_path / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("3d_fullres",), verbose=False)
    monkeypatch.setenv("nnUNet_raw_data_base", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(pre))
    monkeypatch.setenv("RESULTS_FOLDER", str(tmp_path / "results"))
    assert run_training_vit(["3d_fullres", TASK, "0", "-num_epochs", "2", "-num_iters", "2",
                             "-val_iters", "1", "-base_features", "4", "-max_features", "16",
                             "-vit_depth", "1", "--device", "cpu"]) == 0
    fold = (tmp_path / "results" / "nnUNet_ext" / "3d_fullres" / TASK
            / "nnViTUNetTrainer__nnUNetPlansv2.1" / "Generic_ViT_UNetV1" / "base"
            / "not_task_specific" / "traditional" / "fold_0")
    manifest = json.loads((fold / "model_final_checkpoint.json").read_text())
    assert manifest["use_vit"] and manifest["vit"]["version"] == "V1"
    assert manifest["vit"]["depth_override"] == 1 and manifest["batch_size"] == 1
    assert manifest["trainer"] == "ViTUNetTrainer" and manifest["extension"] == "vit_unet"
    progress = json.loads((fold / "progress.json").read_text())
    assert len(progress["step_losses"]) == 4 and all(np.isfinite(progress["step_losses"]))

    model, _, _ = restore_model(str(fold / "model_final_checkpoint"), torch.device("cpu"))
    assert isinstance(model, GenericViTUNet) and model.vit.depth == 1
    assert model.vit.block0.attn.qkv.in_features == 16
    images = os.path.join(synthetic_task, "imagesTr")
    out = tmp_path / "served"
    assert run_inference(["3d_fullres", "nnViTUNetTrainer", "-i", images, "-o", str(out),
                          "-trained_on", TASK, "--use_vit", "--disable_tta",
                          "--device", "cpu"]) == 0
    served = sorted(os.listdir(out))
    assert len(served) == 6
    seg = read_image(str(out / served[0])).data
    label = read_image(os.path.join(synthetic_task, "labelsTr", served[0])).data
    assert seg.shape == label.shape and int(seg.max()) <= 2
