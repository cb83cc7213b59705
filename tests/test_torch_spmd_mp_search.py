"""Model parallelism on the ViT-U-Net and on EWC's state, and the parameter
search over several devices per experiment, on the CPU (spawned ranks over
gloo):

* a ViT-U-Net (V1, ``-vit_depth 1``: embed 16, 2 heads; widths 4 -> 16,
  patch 16^3) through ``nnUNet_torch_train_base_v2 --use_vit -n_devices 2
  -model_parallel 2``: its convs, patch embedding and Linear layers hold
  half their output features, and the parameters agree with world 1's
  within the JAX test's bounds (atol 5e-5, rtol 1e-4);
* ``nnUNet_torch_train_ewc -n_devices 2 -model_parallel 2`` over two
  tasks (the U-Net): the fisher and the anchors are the ranks' slices
  while they train and whole in the checkpoint, which equals world 1's
  (parameters within the bounds above, the bf16 fisher and anchors within
  a bf16 ulp, relative, over a millionth of their largest value);
* ``ParamSearcher.start_searching(n_workers=2, devices_per_exp=2,
  device_backend="cpu")``: each worker trains its experiment at world 2
  (two ranks of its own), and both finish."""

import glob
import os

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.experiment.param_search import ParamSearcher
from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions

torch.set_num_threads(2)
A, B = "Task097_SynthA", "Task098_SynthB"
COMMON = ["-num_epochs", "1", "-num_iters", "2", "-val_iters", "1", "-save_interval", "1",
          "-batch_size", "2", "-base_features", "4", "-max_features", "16", "--device", "cpu"]
VIT = ["3d_fullres", "-t", A] + COMMON + ["--use_vit", "-vit_depth", "1"]


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd_vit")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre), configs=("3d_fullres",),
                        verbose=False)
    return {"root": root, "pre": pre, "plans": Plans.load(plans_path(str(pre / A))),
            "stage": str(pre / A / "nnUNetData_plans_v2.1_3d_fullres")}


def test_the_vit_unet_trains_under_model_parallel_2(env, monkeypatch):
    monkeypatch.setenv("nnUNet_raw_data_base", str(env["root"] / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(env["pre"]))
    params = {}
    for name, extra in (("world1", []), ("mp2", ["-n_devices", "2", "-model_parallel", "2"])):
        monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / name))
        assert run_training("base_v2", VIT + extra) == 0
        (path,) = glob.glob(str(env["root"] / name / "**" / "model_final_checkpoint.pt"),
                            recursive=True)
        blob = torch.load(path, weights_only=True)
        params[name] = {**blob["body"], **blob["heads"][A]}
        (log,) = glob.glob(os.path.join(os.path.dirname(path), "training_log_*.txt"))
        params[name + "_log"] = open(log).read()
    assert "SPMD: mesh data=1 x model=2" in params["mp2_log"]
    assert any(k.startswith("vit.block0.attn.qkv") for k in params["world1"])
    for k, want in params["world1"].items():
        np.testing.assert_allclose(params["mp2"][k].numpy(), want.numpy(), atol=5e-5,
                                   rtol=1e-4, err_msg=k)


def test_ewc_state_under_model_parallel_2_is_world_1s(env, monkeypatch):
    monkeypatch.setenv("nnUNet_raw_data_base", str(env["root"] / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(env["pre"]))
    argv = ["3d_fullres", "-t", A, B] + COMMON + ["-patch_size", "16", "16", "16"]
    blobs = {}
    for name, extra in (("ewc1", []), ("ewc_mp2", ["-n_devices", "2", "-model_parallel", "2"])):
        monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / name))
        assert run_training("ewc", argv + extra) == 0
        (path,) = [p for p in glob.glob(str(env["root"] / name / "**" /
                                             "model_final_checkpoint.pt"), recursive=True)
                   if list(torch.load(p, weights_only=True)["heads"]) == [A, B]]
        blobs[name] = torch.load(path, weights_only=True)
    want, got = blobs["ewc1"], blobs["ewc_mp2"]
    for t in (A, B):
        for k, v in {**want["body"], **want["heads"][t]}.items():
            np.testing.assert_allclose({**got["body"], **got["heads"][t]}[k].numpy(),
                                       v.numpy(), atol=5e-5, rtol=1e-4, err_msg=k)
    for t, state in want["cl_state"]["ewc_tasks"].items():
        for part in ("fisher", "params"):
            # the conv biases' fisher is roundoff (the InstanceNorm absorbs
            # the bias): held to a millionth of the part's largest value
            scale = max(v.float().abs().max().item() for v in state[part].values())
            for k, v in state[part].items():
                g = got["cl_state"]["ewc_tasks"][t][part][k]
                assert g.shape == v.shape and g.dtype == v.dtype == torch.bfloat16, k
                torch.testing.assert_close(g.float(), v.float(), rtol=2 ** -7,
                                           atol=1e-6 * scale, msg=f"{t} {part} {k}")


def test_an_experiment_trains_over_two_devices(env):
    tiny = dict(num_epochs=1, iters_per_epoch=1, val_iters=1, save_every=5, batch_size=2,
                patch_size=(16, 16, 16), augment=False, dtype="float32",
                base_num_features=4, max_num_features=8)
    s = ParamSearcher("ewc", env["plans"], "3d_fullres", {A: env["stage"]},
                      str(env["root"] / "search"), search_mode="grid",
                      grid={"ewc_lambda": [0.1, 0.4]}, options=TrainerOptions(**tiny))
    results = s.start_searching(n_workers=2, devices_per_exp=2, device_backend="cpu")
    assert sorted(results) == ["exp_0", "exp_1"]
    for r in results.values():
        assert r["world"] == 2 and r["device"] == "cpu"
        assert np.isfinite(r["final_mean_dice"])
