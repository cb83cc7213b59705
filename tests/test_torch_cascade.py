"""The cascade's fullres stage on the CPU against the JAX package, as the
JAX test does it (``tests/test_cl_trainers.py:181-232``: the 3d_fullres
stage stands in for the lowres one): from the same lowres weights (a JAX
trainer's, carried over by ``jax_params_to_state_dict``) both packages'
``prepare_cascade_stage`` write the same arrays (modality, two one-hot
foreground channels, seg; float32) and side files, the one-hot channels
equal everywhere (both packages' ``output='seg'`` sums bfloat16-rounded
window probabilities, so the one-hot channels follow the argmax of the f32
probabilities only where its top two classes are more than 1e-2 apart);
``CascadeFullResTrainer`` (3 input channels)
gives JAX's loss and gradients on one batch, and JAX's trainer's loss and
parameters after a step, from the same weights; the registry resolves
the three names; ``restore_trainer`` / ``restore_model`` rebuild the
3-channel network; ``nnUNet_torch_prepare_cascade --device cpu`` runs."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.inference.cascade import (
    CascadeFullResTrainer as JaxCascade, prepare_cascade_stage as jax_prepare)
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu.training.trainers.sequential import SequentialTrainer as JaxSeq
from lifelong_nnunet_tpu_torch.data.dataset import PreprocessedDataset
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.inference.cascade import (CascadeFullResTrainer,
                                                         prepare_cascade_stage)
from lifelong_nnunet_tpu_torch.inference.sliding_window import predict_sliding_window
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import unet_from_plans
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run import prepare_cascade
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.training.checkpoints import base_manifest, save_checkpoint
from lifelong_nnunet_tpu_torch.training.restore import restore_model, restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer

torch.set_num_threads(4)
CPU = torch.device("cpu")
TASK = "Task097_SynthA"
PATCH = (16, 16, 16)
OPTS = dict(num_epochs=1, iters_per_epoch=1, val_iters=1, augment=False, patch_size=PATCH,
            batch_size=2, base_num_features=4, max_num_features=16)


@pytest.fixture(scope="module")
def env(synthetic_task, tmp_path_factory):
    root = tmp_path_factory.mktemp("cascade")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("3d_fullres",), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_raw_data_base", str(root / "raw"))
    mp.setenv("nnUNet_preprocessed", str(pre))
    mp.setenv("RESULTS_FOLDER", str(root / "results"))
    task_dir = pre / TASK
    stage = str(task_dir / "nnUNetData_plans_v2.1_3d_fullres")
    plans, jplans = (P.load(plans_path(str(task_dir))) for P in (Plans, JaxPlans))
    # the lowres stand-in: one JAX training step, its weights saved for the port
    low = JaxSeq(jplans, "3d_fullres", str(root / "jax_low"),
                 JaxOptions(dtype="float32", **OPTS))
    low.train_task(TASK, stage)
    tm = unet_from_plans(plans, "3d_fullres", base_num_features=4, max_num_features=16)
    manifest = dict(base_manifest(plans, "3d_fullres", tm), patch_size=list(PATCH))
    port_low = str(root / "port_low" / "model_final_checkpoint")
    save_checkpoint(port_low, {TASK: jax_params_to_state_dict(low.mh.assemble(), tm)},
                    manifest)
    jax_dir, port_dir = str(task_dir / "jax_cascade"), str(task_dir / "port_cascade")
    jax_written = jax_prepare(str(root / "jax_low" / "model_final_checkpoint"), stage, stage,
                              jax_dir)
    port_written = prepare_cascade_stage(port_low, stage, stage, port_dir, device=CPU)
    yield {"root": root, "pre": pre, "stage": stage, "plans": plans, "jplans": jplans,
           "port_low": port_low, "jax_dir": jax_dir, "port_dir": port_dir,
           "written": (port_written, jax_written)}
    mp.undo()


def test_prepared_stage_matches_jax(env):
    port_written, jax_written = env["written"]
    assert port_written == jax_written and len(port_written) == 6
    model, _, _ = restore_model(env["port_low"], CPU)
    seen = set()
    for case in port_written:
        got = np.load(os.path.join(env["port_dir"], f"{case}.npy"))
        want = np.load(os.path.join(env["jax_dir"], f"{case}.npy"))
        full = np.asarray(PreprocessedDataset(env["stage"]).load(case))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert got.shape == (1 + 2 + 1,) + full.shape[1:]
        np.testing.assert_array_equal(got[:1], full[:1])      # the modality first
        np.testing.assert_array_equal(got[-1], full[-1])      # the seg last
        onehot = got[1:3]
        assert set(np.unique(onehot)) <= {0.0, 1.0}
        assert not (onehot.sum(0) > 1).any()                  # one class per voxel
        seen |= set(np.unique(onehot).tolist())
        # the stand-in's lowres grid is the fullres one: no zoom between
        probs = predict_sliding_window(model, np.moveaxis(full[:-1], 0, -1), PATCH, 3,
                                       device=CPU, mirror_axes=(), window_batch=8,
                                       input_bf16=True)
        top2 = np.sort(probs, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-2
        for c in range(2):
            np.testing.assert_array_equal(onehot[c][clear], (probs.argmax(-1) == c + 1)[clear])
        np.testing.assert_array_equal(onehot, want[1:3])
        for suffix in (".props.json", ".classlocs.npz"):
            assert os.path.isfile(os.path.join(env["port_dir"], case + suffix)) == \
                os.path.isfile(os.path.join(env["jax_dir"], case + suffix)) == True  # noqa: E712
    assert seen == {0.0, 1.0}, seen                           # not a vacuous stage


def test_cascade_train_step_matches_jax(env, tmp_path):
    """One batch of the cascade stage (3 input channels) through the JAX
    trainer's initial weights: loss to 1e-5 relative, each gradient to
    1e-4 of its scale (``test_torch_train_step.py``); then one trainer step
    of each package from those weights on the same stage: the train and
    validation losses to 1e-4 relative and every parameter to 1e-4
    (``test_torch_training_e2e.py``)."""
    jax_tr = JaxCascade(env["jplans"], "3d_fullres", str(tmp_path / "jax"),
                        JaxOptions(dtype="float32", **OPTS))
    jax_tr.train_task(TASK, env["jax_dir"])
    assert jax_tr.in_channels == 3
    init, _, _ = jax_checkpoints.load_checkpoint(str(tmp_path / "jax" / "before_training"))
    params = init.assemble()
    port = CascadeFullResTrainer(env["plans"], "3d_fullres", str(tmp_path / "port"),
                                 TrainerOptions(device="cpu", **OPTS))
    assert port.in_channels == 3 and port.model.enc0.block0.conv.in_channels == 3
    state = jax_params_to_state_dict(params, port.model)
    kernel = np.asarray(params["enc0"]["block0"]["Conv_0"]["kernel"])
    assert kernel.shape == (3, 3, 3, 3, 4)                   # [*k, Cin, Cout] in flax
    np.testing.assert_array_equal(state["enc0.block0.conv.weight"].numpy(),
                                  kernel.transpose(4, 3, 0, 1, 2))
    port.model.load_state_dict(state)

    ds = PreprocessedDataset(env["jax_dir"])
    batch = PatchSampler(ds, ds.cases, PATCH, 2, seed=4).next_batch()
    assert batch["data"].shape == (2, 3) + PATCH
    data = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_ds_loss(
        jax_tr.model.apply({"params": p}, data), jnp.asarray(batch["seg"]).astype(jnp.int32),
        port.ds_factors, True)))(params)
    got = deep_supervision_loss(port.model(torch.from_numpy(batch["data"])),
                                torch.from_numpy(batch["seg"]).long(), port.ds_factors, True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), port.model)
    for name, p in port.model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert (g - want[name]).abs().max().item() <= 1e-4 * want[name].abs().max() + 1e-6, \
            name

    port.model.zero_grad(set_to_none=True)
    port.train_task(TASK, env["jax_dir"])
    for a, b in zip(port._epoch_log, jax_tr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=1e-4)
    final = jax_params_to_state_dict(jax_tr.mh.assemble(), port.model)
    for name, value in port.mh.assemble().items():
        assert (value - final[name]).abs().max().item() <= 1e-4, name

    # the checkpoint rebuilds the 3-channel network
    base = str(tmp_path / "port" / "model_final_checkpoint")
    manifest = json.loads(open(base + ".json").read())
    assert manifest["extension"] == "cascade_fullres" and manifest["in_channels"] == 3
    again = restore_trainer(base, TrainerOptions(device="cpu"))
    assert type(again) is CascadeFullResTrainer and again.in_channels == 3
    assert again.mh.tasks == [TASK]
    model, _, _ = restore_model(base, CPU)
    assert model.enc0.block0.conv.in_channels == 3
    for name, value in port.mh.assemble().items():
        assert torch.equal(model.state_dict()[name], value), name


@pytest.mark.parametrize("name", ["cascade_fullres", "CascadeFullResTrainer",
                                  "nnViTUNetTrainer_CascadeFullRes"])
def test_registry_resolves_the_cascade_trainer(name):
    assert get_trainer(name) is CascadeFullResTrainer
    assert CascadeFullResTrainer.EXTENSION == "cascade_fullres"


def test_prepare_cascade_cli_on_the_cpu(env, monkeypatch):
    """``nnUNet_torch_prepare_cascade -t 97 -ckpt <lowres> --device cpu``
    writes the stage the library call wrote, bit for bit, where the
    trainer API reads it; ``cuda`` without a GPU raises before any work."""
    argv = ["-t", "97", "-ckpt", env["port_low"], "-lowres_config", "3d_fullres"]
    assert prepare_cascade.main(argv + ["--device", "cpu"]) == 0
    out = prepare_cascade.cascade_stage_dir(str(env["pre"]), TASK)
    assert out.endswith("nnUNetData_plans_v2.1_cascade_fullres")
    names = sorted(os.listdir(env["port_dir"]))
    assert sorted(os.listdir(out)) == names
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(out, n)),
                                          np.load(os.path.join(env["port_dir"], n)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        prepare_cascade.main(argv)
