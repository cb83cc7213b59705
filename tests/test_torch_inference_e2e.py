"""The ported serving path end to end on the CPU: a synthetic task is
planned and preprocessed, a JAX-initialized tiny U-Net is converted and
saved as a port checkpoint in the base-trainer results layout, and the
port's CLI entry (``run_inference``) segments the task's images.  The JAX
package's ``predict_from_folder`` with the same weights must produce the
same segmentations on >= 99.9% of voxels."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.inference.predict import predict_from_folder as jax_predict
from lifelong_nnunet_tpu.models.unet import unet_from_plans as jax_unet_from_plans
from lifelong_nnunet_tpu.planning.plans import Plans, plans_path
from lifelong_nnunet_tpu.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu.utilities.imageio import read_image
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import unet_from_plans
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.training.checkpoints import (base_manifest,
                                                            save_checkpoint)
from lifelong_nnunet_tpu_torch.training.restore import find_checkpoint, restore_model
from tests.synthetic import make_synthetic_task

torch.set_num_threads(2)
TASK = "Task097_SynthA"
WIDTHS = dict(base_num_features=4, max_num_features=16)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    env = {"nnUNet_raw_data_base": str(root / "raw"),
           "nnUNet_preprocessed": str(root / "pre"),
           "RESULTS_FOLDER": str(root / "results")}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        raw = root / "raw" / "nnUNet_raw_data"
        task_dir = make_synthetic_task(str(raw), task_name=TASK, num_cases=2,
                                       seed=0, shape=(20, 26, 22))
        plan_and_preprocess([task_dir], str(root / "pre"), configs=("3d_fullres",),
                            verbose=False)
        plans = Plans.load(plans_path(str(root / "pre" / TASK)))
        cfg = plans.config("3d_fullres")
        jm = jax_unet_from_plans(plans, "3d_fullres").clone(**WIDTHS)
        params = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(3),
            jnp.zeros((1,) + tuple(cfg.patch_size) + (plans.num_modalities,)))["params"])
        tm = unet_from_plans(plans, "3d_fullres", **WIDTHS)
        fold = (root / "results" / "nnUNet_ext" / "3d_fullres" / TASK
                / "nnUNetTrainerV2__nnUNetPlansv2.1" / "Generic_UNet" / "fold_0")
        base = str(fold / "model_final_checkpoint")
        state = jax_params_to_state_dict(params, tm)
        save_checkpoint(base, {TASK: state}, base_manifest(plans, "3d_fullres", tm))
        images = os.path.join(task_dir, "imagesTr")
        out_t, out_j = str(root / "seg_torch"), str(root / "seg_jax")
        assert run_inference(["3d_fullres", "nnUNetTrainerV2", "-i", images,
                              "-o", out_t, "-trained_on", "97",
                              "--device", "cpu"]) == 0
        jax_predict(lambda p, x: jm.apply({"params": p}, x), [params], plans,
                    "3d_fullres", images, out_j, volume_batch=1, window_batch=8)
        yield dict(root=root, plans=plans, base=base, out_t=out_t, out_j=out_j,
                   state=state, images=images)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_segmentations_match_jax(served):
    names = sorted(os.listdir(served["out_j"]))
    assert names == sorted(os.listdir(served["out_t"])) == \
        ["synth_000.nii.gz", "synth_001.nii.gz"]
    for n in names:
        seg_t = np.asarray(read_image(os.path.join(served["out_t"], n)).data)
        seg_j = np.asarray(read_image(os.path.join(served["out_j"], n)).data)
        image = read_image(os.path.join(served["images"], n.replace(".nii", "_0000.nii")))
        assert seg_t.shape == seg_j.shape == np.asarray(image.data).shape
        assert len(np.unique(seg_j)) >= 2      # not a constant, vacuous map
        agree = float((seg_t == seg_j).mean())
        assert agree >= 0.999, (n, agree)


def test_checkpoint_restores_model_and_plans(served):
    base = find_checkpoint(os.path.dirname(served["base"]))
    assert base == served["base"] and os.path.isfile(base + ".json")
    model, plans, config_name = restore_model(base, torch.device("cpu"))
    assert config_name == "3d_fullres" and not model.training
    assert dataclasses.asdict(plans) == dataclasses.asdict(served["plans"])
    assert model.base_num_features == 4 and model.dtype == torch.float32
    for k, v in served["state"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_cuda_without_a_gpu_raises(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_inference(["3d_fullres", "nnUNetTrainerV2", "-i", served["images"],
                       "-o", str(served["root"] / "never"), "-trained_on", TASK,
                       "--device", "cuda"])
    assert not (served["root"] / "never").exists()


REFUSED = {  # id: (trainer, extra arguments)
    "extra0": ("nnViTUNetTrainer", ["--task_specific_ln"]),
    "extra3": ("nnUNetTrainerV2", ["--task_specific_ln"]),
    "extra6": ("lwf", []), "extra7": ("mib", ["--use_vit"])}


@pytest.mark.parametrize("trainer,extra", list(REFUSED.values()), ids=list(REFUSED))
def test_unported_model_layouts_are_refused(served, trainer, extra):
    """Trainers the port does not train yet, and every option of the JAX
    CLI that acts on a model the port does not serve yet (task-specific
    LayerNorms), are refused instead of ignored."""
    with pytest.raises(NotImplementedError):
        run_inference(["3d_fullres", trainer, "-i", served["images"], "-o",
                       str(served["root"] / "never"), "-trained_on", TASK,
                       "--device", "cpu"] + extra)
