"""The port's training path end to end on the CPU, through its entry points:
``nnUNet_torch_train_base_v2 --device cpu`` trains a tiny U-Net (widths
4 -> 16, patch 16^3) for 2 epochs of 3 steps, writes the checkpoints, the
progress record and the trained-on manifest, and ``nnUNet_torch_inference
--device cpu`` serves what it wrote; unported options raise.  Then the JAX
package's trainer and the port's, from the same initial parameters with no
augmentation, give the same per-epoch train and validation losses."""

import json
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu.training.trainers.sequential import BaseUNetTrainer as JaxBase
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer
from lifelong_nnunet_tpu_torch.training.trainers.sequential import BaseUNetTrainer
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image

torch.set_num_threads(4)

TASK = "Task097_SynthA"
TINY = ["-patch_size", "16", "16", "16", "-base_features", "4", "-max_features", "16"]


@pytest.fixture(scope="module")
def env(synthetic_task, tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("3d_fullres",), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_raw_data_base", str(root / "raw"))
    mp.setenv("nnUNet_preprocessed", str(pre))
    mp.setenv("RESULTS_FOLDER", str(root / "results"))
    yield {"root": root, "pre": pre, "raw": synthetic_task,
           "stage": pre / TASK / "nnUNetData_plans_v2.1_3d_fullres"}
    mp.undo()


def test_train_then_serve_through_the_entry_points(env):
    assert run_training("base_v2", ["3d_fullres", "-t", TASK, "-num_epochs", "2",
                                    "-num_iters", "3", "-val_iters", "2",
                                    "--device", "cpu"] + TINY) == 0
    base = env["root"] / "results" / "nnUNet_ext" / "3d_fullres" / TASK
    fold = base / TASK / "nnUNetTrainerBase_v2__nnUNetPlansv2.1" / "Generic_UNet" / "SEQ" \
        / "fold_0"
    for name in ("before_training", "model_best", "model_latest", "model_final_checkpoint"):
        assert (fold / f"{name}.pt").is_file() and (fold / f"{name}.json").is_file(), name
    blob = torch.load(fold / "model_final_checkpoint.pt", weights_only=True)
    assert list(blob["heads"]) == [TASK] and blob["step"] == 6 and blob["epoch"] == 1
    assert blob["optimizer"]["step"] == 6
    manifest = json.loads((fold / "model_final_checkpoint.json").read_text())
    assert (manifest["meta"]["task_order"], manifest["meta"]["active_task"]) == ([TASK], TASK)
    assert manifest["trainer"] == "BaseUNetTrainer" and manifest["base_num_features"] == 4
    progress = json.loads((fold / "progress.json").read_text())
    assert len(progress["step_losses"]) == 6 and len(progress["epochs"]) == 2
    assert all(np.isfinite(progress["step_losses"]))
    trained_on = json.loads((base / "metadata" / "nnUNetTrainerBase_v2__nnUNetPlansv2.1"
                             / "Generic_UNet" / "SEQ" / "base_v2_trained_on.json").read_text())
    assert trained_on["0"]["finished_training_on"] == [TASK]
    assert trained_on["0"]["start_training_on"] is None

    images = os.path.join(env["raw"], "imagesTr")
    out = env["root"] / "served"
    assert run_inference(["3d_fullres", "base_v2", "-i", images, "-o", str(out),
                          "-trained_on", TASK, "--device", "cpu"]) == 0
    served = sorted(os.listdir(out))
    assert len(served) == 6
    seg = read_image(str(out / served[0])).data
    label = read_image(os.path.join(env["raw"], "labelsTr", served[0])).data
    assert seg.shape == label.shape and int(seg.max()) <= 2


def test_base_v2_trains_and_serves_the_vit_unet(env):
    """``--use_vit`` on ``nnUNet_torch_train_base_v2``: the ViT-U-Net (V1,
    ``-vit_depth 1``, at the plans' patch, which serving windows with) is
    written under the ViT's architecture folder, at half the plans' batch,
    and ``nnUNet_torch_inference base_v2 --use_vit`` finds it there."""
    vit = ["--use_vit", "-vit_depth", "1"]
    assert run_training("base_v2", ["3d_fullres", "-t", TASK, "-num_epochs", "1",
                                    "-num_iters", "2", "-val_iters", "1",
                                    "--device", "cpu"] + TINY[4:] + vit) == 0
    fold = (env["root"] / "results" / "nnUNet_ext" / "3d_fullres" / TASK / TASK
            / "nnUNetTrainerBase_v2__nnUNetPlansv2.1" / "Generic_ViT_UNetV1" / "base"
            / "not_task_specific" / "traditional" / "SEQ" / "fold_0")
    manifest = json.loads((fold / "model_final_checkpoint.json").read_text())
    assert manifest["use_vit"] and manifest["batch_size"] == 1
    assert manifest["vit"]["depth_override"] == 1
    out = env["root"] / "served_vit"
    assert run_inference(["3d_fullres", "base_v2", "-i", os.path.join(env["raw"], "imagesTr"),
                          "-o", str(out), "-trained_on", TASK, "--disable_tta",
                          "--device", "cpu"] + vit[:1]) == 0
    assert len(os.listdir(out)) == 6


def test_cuda_without_a_gpu_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_training("base_v2", ["3d_fullres", "-t", TASK, "-num_epochs", "1",
                                 "--device", "cuda"] + TINY)


@pytest.mark.parametrize("extra", [
    pytest.param(["--task_specific_ln"], id="extra2"),
    pytest.param(["-n_devices", "2"], id="extra3"),
    pytest.param(["-model_parallel", "2"], id="extra4"),
    pytest.param(["--remat"], id="extra7")])
def test_unported_options_are_refused(env, extra):
    with pytest.raises(NotImplementedError):
        run_training("base_v2", ["3d_fullres", "-t", TASK, "--device", "cpu"] + extra)


def test_only_the_ported_trainers_are_registered():
    assert get_trainer("nnUNetTrainerV2") is BaseUNetTrainer
    with pytest.raises(NotImplementedError, match="lwf"):
        get_trainer("lwf")


def test_trainers_give_the_jax_trainers_losses(env, tmp_path):
    """The same plans, split, sampler seeds and initial parameters, f32,
    no augmentation: per-epoch train and validation losses to 1e-4
    relative (XLA's and PyTorch's f32 convs sum in different orders, over
    6 SGD steps with momentum 0.99), final parameters to 1e-4."""
    kw = dict(num_epochs=2, iters_per_epoch=3, val_iters=2, augment=False,
              patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
    jplans = JaxPlans.load(plans_path(str(env["pre"] / TASK)))
    jax_tr = JaxBase(jplans, "3d_fullres", str(tmp_path / "jax"), JaxOptions(**kw))
    jax_tr.train_task(TASK, str(env["stage"]))
    init, _, _ = jax_checkpoints.load_checkpoint(str(tmp_path / "jax" / "before_training"))

    plans = Plans.load(plans_path(str(env["pre"] / TASK)))
    assert asdict(plans) == asdict(jplans)
    port = BaseUNetTrainer(plans, "3d_fullres", str(tmp_path / "port"),
                           TrainerOptions(device="cpu", **kw))
    port.model.load_state_dict(jax_params_to_state_dict(init.assemble(), port.model))
    port.train_task(TASK, str(env["stage"]))

    for a, b in zip(port._epoch_log, jax_tr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=1e-4)
    want = jax_params_to_state_dict(jax_tr.mh.assemble(), port.model)
    for name, value in port.mh.assemble().items():
        assert (value - want[name]).abs().max().item() <= 1e-4, name


def test_vit_trainers_give_the_jax_trainers_losses(env, tmp_path):
    """As above for the ViT-U-Net (V1, the trainer's ``vit_depth_override``
    1: embed 16, 2 heads): both trainers halve the plans' batch to 1 and
    give the same per-epoch losses, to 1e-4 relative, and final
    parameters, to 1e-4."""
    kw = dict(num_epochs=2, iters_per_epoch=2, val_iters=1, augment=False,
              patch_size=(16, 16, 16), base_num_features=4, max_num_features=16,
              use_vit=True, vit_depth_override=1)
    jplans = JaxPlans.load(plans_path(str(env["pre"] / TASK)))
    jax_tr = JaxBase(jplans, "3d_fullres", str(tmp_path / "jax"), JaxOptions(**kw))
    jax_tr.train_task(TASK, str(env["stage"]))
    init, _, _ = jax_checkpoints.load_checkpoint(str(tmp_path / "jax" / "before_training"))

    port = BaseUNetTrainer(Plans.load(plans_path(str(env["pre"] / TASK))), "3d_fullres",
                           str(tmp_path / "port"), TrainerOptions(device="cpu", **kw))
    assert port.batch_size == jax_tr.batch_size == 1
    port.model.load_state_dict(jax_params_to_state_dict(init.assemble(), port.model))
    port.train_task(TASK, str(env["stage"]))

    for a, b in zip(port._epoch_log, jax_tr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=1e-4)
    want = jax_params_to_state_dict(jax_tr.mh.assemble(), port.model)
    for name, value in port.mh.assemble().items():
        assert (value - want[name]).abs().max().item() <= 1e-4, name
