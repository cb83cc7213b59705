"""The ``2d`` configuration on the CPU against the JAX package: a synthetic
task planned and preprocessed to its 2d stage; the sampler's 2D slices
(the same seed gives the same batches), one train step's loss and
gradients on a tiny 2D U-Net (widths 4 -> 16, patch 16 x 16, the same
weights), the Sequential trainers' losses and their sliding-window
validation (2D over the 3D validation volumes) from the same weights; and
``nnUNet_torch_train_sequential 2d --use_progress_val`` (the counterpart
of ``tests/test_cli_e2e.py:199``) ending in that validation, served by
``nnUNet_torch_inference 2d`` and scored by ``nnUNet_torch_evaluate 2d``."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.data.dataset import PreprocessedDataset as JaxDataset
from lifelong_nnunet_tpu.data.sampler import PatchSampler as JaxSampler
from lifelong_nnunet_tpu.models.unet import unet_from_plans as jax_unet_from_plans
from lifelong_nnunet_tpu.ops.losses import deep_supervision_loss as jax_ds_loss
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu.training.trainers.sequential import SequentialTrainer as JaxSeq
from lifelong_nnunet_tpu_torch.data.dataset import PreprocessedDataset
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import ds_scale_factors, unet_from_plans
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_evaluation import run_evaluation
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers.sequential import SequentialTrainer
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image

torch.set_num_threads(4)
TASK = "Task097_SynthA"
PATCH, BATCH = (16, 16), 4
WIDTHS = dict(base_num_features=4, max_num_features=16)
TINY = ["-patch_size", "16", "16", "-batch_size", "4", "-base_features", "4",
        "-max_features", "16"]


@pytest.fixture(scope="module")
def env(synthetic_task, tmp_path_factory):
    root = tmp_path_factory.mktemp("cfg2d")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("2d",), verbose=False)
    mp = pytest.MonkeyPatch()
    for key, sub in (("nnUNet_raw_data_base", "raw"), ("nnUNet_preprocessed", "pre"),
                     ("RESULTS_FOLDER", "results"), ("EVALUATION_FOLDER", "eval")):
        mp.setenv(key, str(root / sub))
    stage = pre / TASK / "nnUNetData_plans_v2.1_2d"
    yield {"root": root, "pre": pre, "raw": synthetic_task, "stage": str(stage),
           "plans": Plans.load(plans_path(str(pre / TASK))),
           "jplans": JaxPlans.load(plans_path(str(pre / TASK)))}
    mp.undo()


def test_2d_sampler_slices_match_jax(env):
    """The 2D sampler draws a slice along the leading axis, then a patch on
    it, foreground-forced for the last third: the same batches as JAX's."""
    port = PatchSampler(PreprocessedDataset(env["stage"]), PreprocessedDataset(
        env["stage"]).cases, PATCH, BATCH, seed=3)
    ref = JaxSampler(JaxDataset(env["stage"]), JaxDataset(env["stage"]).cases, PATCH, BATCH,
                     seed=3)
    fg = 0
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        assert a["data"].shape == (BATCH, 1) + PATCH and a["keys"] == b["keys"]
        np.testing.assert_array_equal(a["data"], np.moveaxis(b["data"], -1, 1))
        np.testing.assert_array_equal(a["seg"], b["seg"])
        fg += int((a["seg"] > 0).sum())
    assert fg > 0


def test_2d_train_step_loss_and_gradients_match_jax(env):
    """Loss to 1e-5 relative, each gradient to 1e-4 of its scale (as
    ``test_torch_train_step.py``), batch Dice as the 2d configuration
    pools it."""
    plans, cfg = env["plans"], env["plans"].config("2d")
    jm = jax_unet_from_plans(env["jplans"], "2d").clone(dtype=jnp.float32, **WIDTHS)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(2), jnp.zeros((1,) + PATCH + (1,)))["params"])
    batch = PatchSampler(PreprocessedDataset(env["stage"]), PreprocessedDataset(
        env["stage"]).cases, PATCH, BATCH, seed=5).next_batch()
    ds = tuple(ds_scale_factors(cfg.pool_op_kernel_sizes))
    assert len(ds[0]) == 2
    data = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_ds_loss(
        jm.apply({"params": p}, data), jnp.asarray(batch["seg"]).astype(jnp.int32), ds,
        True)))(params)
    model = unet_from_plans(plans, "2d", **WIDTHS)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    got = deep_supervision_loss(model(torch.from_numpy(batch["data"])),
                                torch.from_numpy(batch["seg"]).long(), ds, True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), model)
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= 1e-4 * scale + 1e-6, name


def _dice(history) -> dict:
    """{subject: per-class Dice} of the last validation."""
    ((_, r),) = history[-1]["results"].items()
    return {s: np.asarray(m["Dice"]) for s, m in r["subjects"].items()}


def test_2d_trainers_and_their_validation_match_jax(env, tmp_path):
    """The same plans, split, sampler seeds and initial parameters, f32, no
    augmentation, 1 epoch of 2 steps: the train and validation losses to
    1e-4 relative; then the sliding-window validation (each validation
    volume predicted slice by slice) from the JAX trainer's final
    parameters: the same per-subject Dice to 1e-3 (a voxel whose two
    classes tie within f32 roundoff may go either way)."""
    kw = dict(num_epochs=1, iters_per_epoch=2, val_iters=1, augment=False,
              patch_size=PATCH, batch_size=BATCH, use_progress_val=True, **WIDTHS)
    jax_tr = JaxSeq(env["jplans"], "2d", str(tmp_path / "jax"),
                    JaxOptions(dtype="float32", **kw))
    jax_tr.train_task(TASK, env["stage"])
    init, _, _ = jax_checkpoints.load_checkpoint(str(tmp_path / "jax" / "before_training"))
    port = SequentialTrainer(env["plans"], "2d", str(tmp_path / "port"),
                             TrainerOptions(device="cpu", **kw))
    assert port.batch_dice and port.in_channels == 1
    port.model.load_state_dict(jax_params_to_state_dict(init.assemble(), port.model))
    port.train_task(TASK, env["stage"])
    for a, b in zip(port._epoch_log, jax_tr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=1e-4)
    want = _dice(jax_tr._val_history)
    assert set(_dice(port._val_history)) == set(want)
    port.mh = port.mh.absorb(jax_params_to_state_dict(jax_tr.mh.assemble(), port.model), TASK)
    port._perform_validation(tag="jax weights")
    got = _dice(port._val_history)
    for subject, d in want.items():
        np.testing.assert_allclose(got[subject], d, atol=1e-3)


def test_2d_cli_trains_validates_serves_and_evaluates(env):
    assert run_training("sequential", ["2d", "-t", "97", "-num_epochs", "1", "-num_iters",
                                       "2", "-val_iters", "1", "--use_progress_val",
                                       "--device", "cpu"] + TINY) == 0
    fold = (env["root"] / "results" / "nnUNet_ext" / "2d" / TASK / TASK
            / "nnUNetTrainerSequential__nnUNetPlansv2.1" / "Generic_UNet" / "SEQ" / "fold_0")
    manifest = json.loads((fold / "model_final_checkpoint.json").read_text())
    assert manifest["config_name"] == "2d" and manifest["in_channels"] == 1
    history = json.loads((fold / "val_metrics.json").read_text())
    subjects = history[-1]["results"][TASK]["subjects"]
    assert subjects and all(len(m["Dice"]) == 2 for m in subjects.values())
    images = os.path.join(env["raw"], "imagesTr")
    out = env["root"] / "served_2d"
    assert run_inference(["2d", "sequential", "-i", images, "-o", str(out), "-trained_on",
                          "97", "--device", "cpu"]) == 0
    names = sorted(os.listdir(out))
    assert len(names) == 6
    seg = read_image(str(out / names[0])).data
    assert seg.shape == read_image(os.path.join(env["raw"], "labelsTr", names[0])).data.shape
    assert run_evaluation(["2d", "sequential", "-trained_on", "97", "-evaluate_on", "97",
                           "--device", "cpu"]) == 0
    scored = [f for _, _, fs in os.walk(env["root"] / "eval") for f in fs]
    assert any(f.startswith("val_metrics_eval") for f in scored), scored
