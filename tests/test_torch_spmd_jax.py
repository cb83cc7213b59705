"""Data-parallel training in the port against the JAX trainer's SPMD, on the
CPU: ``nnUNet_torch_train_<ext> -n_devices 2`` (two spawned ranks over
gloo) and the JAX trainer with ``n_devices=2`` on its 8-device virtual CPU
mesh, both over two tiny tasks (widths 4 -> 16, patch 16^3, f32, no
augmentation) from the same initial parameters (the JAX run's, converted
by ``models/convert.py`` into a checkpoint the CLI starts from with
``--init_seq``), for ``sequential``, ``ewc`` (the fisher of the
all-reduced, global-batch gradient) and ``plop`` (the thresholds of the
histograms summed over the ranks, the taps, the pseudo-label and POD
terms over the global batch).  The per-epoch train and validation losses
agree to 1e-4 relative and the final parameters of both tasks' heads to
1e-4, the tolerance of ``tests/test_torch_training_e2e.py``'s world-1
comparison."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training import trainers as ptrainers
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from tests.test_torch_cl_pod import jax_pod_distance_repaired

torch.set_num_threads(2)
A, B = "Task097_SynthA", "Task098_SynthB"
KW = dict(num_epochs=1, iters_per_epoch=2, val_iters=1, save_every=1, augment=False,
          patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
ARGV = ["3d_fullres", "-t", A, B, "-num_epochs", "1", "-num_iters", "2", "-val_iters", "1",
        "-save_interval", "1", "--no_augment", "-patch_size", "16", "16", "16",
        "-base_features", "4", "-max_features", "16", "--device", "cpu", "-n_devices", "2"]
TOL = 1e-4


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd_jax")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre), configs=("3d_fullres",),
                        verbose=False)
    return {"root": root, "pre": pre, "jplans": JaxPlans.load(plans_path(str(pre / A))),
            "plans": Plans.load(plans_path(str(pre / A))),
            "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B)}}


@pytest.mark.parametrize("ext", ["sequential", "ewc", "plop"])
def test_n_devices_2_gives_the_jax_trainers_losses_and_parameters(env, ext, tmp_path,
                                                                  monkeypatch):
    monkeypatch.setattr(jcl, "local_pod_distance", jax_pod_distance_repaired)
    jax_tr = jtrainers.get_trainer(ext)(env["jplans"], "3d_fullres", str(tmp_path / "jax"),
                                        JaxOptions(**KW, n_devices=2))
    for t in (A, B):
        jax_tr.set_output_folder(str(tmp_path / "jax" / t))
        jax_tr.train_task(t, env["stage"][t])
    assert jax_tr.batch_size % 2 == 0
    init, _, _ = jax_checkpoints.load_checkpoint(str(tmp_path / "jax" / A / "before_training"))

    # the JAX run's initial parameters as a port checkpoint of task A
    seed = ptrainers.get_trainer(ext)(env["plans"], "3d_fullres", str(tmp_path / "init"),
                                      TrainerOptions(device="cpu", **KW))
    seed.model.load_state_dict(jax_params_to_state_dict(init.assemble(), seed.model))
    seed._ensure_initialized(A)
    seed.save_checkpoint("init")

    for var, value in (("nnUNet_raw_data_base", env["root"] / "raw"),
                       ("nnUNet_preprocessed", env["pre"]),
                       ("RESULTS_FOLDER", tmp_path / "port")):
        monkeypatch.setenv(var, str(value))
    assert run_training(ext, ARGV + ["--init_seq", "-initialize_with_network_trainer",
                                     str(tmp_path / "init" / "init")]) == 0
    finals = [p for p in glob.glob(str(tmp_path / "port" / "**" / "model_final_checkpoint.pt"),
                                   recursive=True)
              if list(torch.load(p, weights_only=True)["heads"]) == [A, B]]
    assert len(finals) == 1, finals
    folder = os.path.dirname(finals[0])
    progress = json.loads(open(os.path.join(folder, "progress.json")).read())["epochs"]
    assert [e["task"] for e in progress] == [A, B]
    for a, b in zip(progress, jax_tr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=TOL)
    blob = torch.load(finals[0], weights_only=True)
    model = seed.model
    for t in (A, B):
        want = jax_params_to_state_dict(jax_tr.mh.assemble(t), model)
        got = {**blob["body"], **blob["heads"][t]}
        for name, value in got.items():
            assert (value - want[name]).abs().max().item() <= TOL, (t, name)
