"""The port's multi-device training against itself at world 1, on the CPU,
through ``nnUNet_torch_train_base_v2`` (spawned ranks over gloo): a tiny
U-Net (widths 4 -> 16, patch 16^3, batch 2, augmentation on, f32) for one
epoch of two steps on task A.

* ``-n_devices 2`` (data parallel, one row a rank): the augmentation's
  draws are the global batch's, so the parameters equal world 1's within
  f32 roundoff;
* ``-n_devices 2 -model_parallel 2`` and ``-n_devices 4 -model_parallel
  2``: the parameters agree with world 1's within the JAX test's bounds
  (``tests/test_trainer.py:184-201``, atol 5e-5, rtol 1e-4), and the
  per-rank parameter bytes (rank 0's log) are below 0.62 x data parallel's;
* checkpoints are layout-free: the one written under model parallel 2 is
  read by ``restore_trainer`` at world 1 with the same assembled
  parameters, served by ``nnUNet_torch_inference``, and ``-c`` at world 1
  continues it (parameters, momentum and step count) for a second epoch
  to world 1's own continuation within the bounds above."""

import glob
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training.restore import restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions

torch.set_num_threads(2)
A = "Task097_SynthA"
ARGV = ["3d_fullres", "-t", A, "-num_epochs", "1", "-num_iters", "2", "-val_iters", "1",
        "-save_interval", "1", "-batch_size", "2", "-patch_size", "16", "16", "16",
        "-base_features", "4", "-max_features", "16", "--device", "cpu"]
LAYOUTS = {"world1": [], "dp2": ["-n_devices", "2"],
           "mp2": ["-n_devices", "2", "-model_parallel", "2"],
           "dp2_mp2": ["-n_devices", "4", "-model_parallel", "2"]}


def _final(root):
    (path,) = glob.glob(os.path.join(root, "**", "model_final_checkpoint.pt"), recursive=True)
    return path[:-3]


def _params(base):
    blob = torch.load(base + ".pt", weights_only=True)
    return {**blob["body"], **blob["heads"][A]}


def _bytes_per_rank(base):
    (log,) = glob.glob(os.path.join(os.path.dirname(base), "training_log_*.txt"))
    return int(re.search(r"parameter bytes per rank (\d+)", open(log).read()).group(1))


@pytest.fixture(scope="module")
def runs(synthetic_task, tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd_port")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("3d_fullres",), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_raw_data_base", str(root / "raw"))
    mp.setenv("nnUNet_preprocessed", str(pre))
    out = {}
    for name, extra in LAYOUTS.items():
        mp.setenv("RESULTS_FOLDER", str(root / name))
        assert run_training("base_v2", ARGV + extra) == 0
        out[name] = _final(str(root / name))
    yield {"root": root, "pre": pre, "raw": synthetic_task, "final": out, "mp": mp}
    mp.undo()


@pytest.mark.parametrize("layout,atol,rtol", [("dp2", 1e-6, 1e-5), ("mp2", 5e-5, 1e-4),
                                              ("dp2_mp2", 5e-5, 1e-4)])
def test_layouts_train_the_world_1_parameters(runs, layout, atol, rtol):
    want, got = _params(runs["final"]["world1"]), _params(runs["final"][layout])
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=rtol,
                                   err_msg=k)
    blob = torch.load(runs["final"][layout] + ".pt", weights_only=True)
    ref = torch.load(runs["final"]["world1"] + ".pt", weights_only=True)
    # the optimizer's momentum is saved whole, in the world-1 layout
    for i, v in ref["optimizer"]["sgd"]["state"].items():
        np.testing.assert_allclose(blob["optimizer"]["sgd"]["state"][i]["momentum_buffer"],
                                   v["momentum_buffer"], atol=atol * 10, rtol=rtol)


def test_model_parallel_shards_the_parameter_bytes(runs):
    dp = _bytes_per_rank(runs["final"]["dp2"])
    for layout in ("mp2", "dp2_mp2"):
        assert _bytes_per_rank(runs["final"][layout]) < 0.62 * dp


def _interrupt(root):
    """Mark task A of the run under ``root`` as started and not finished, as
    a run stopped after its epoch-0 checkpoint leaves its manifest."""
    (path,) = glob.glob(os.path.join(root, "**", "base_v2_trained_on.json"), recursive=True)
    manifest = json.loads(open(path).read())
    manifest["0"].update(finished_training_on=[], finished_validation_on=[],
                         start_training_on=A)
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_a_model_parallel_checkpoint_restores_serves_and_resumes_at_world_1(runs, tmp_path):
    base = runs["final"]["mp2"]
    tr = restore_trainer(base, TrainerOptions(device="cpu"))
    assert tr.mesh is None and tr.plan is None
    saved = _params(base)
    for k, v in tr.mh.assemble(A).items():
        assert torch.equal(v, saved[k]), k
    mp = runs["mp"]
    mp.setenv("RESULTS_FOLDER", str(runs["root"] / "mp2"))
    out = tmp_path / "served"
    assert run_inference(["3d_fullres", "base_v2", "-i", os.path.join(runs["raw"], "imagesTr"),
                          "-o", str(out), "-trained_on", A, "--device", "cpu"]) == 0
    assert len(os.listdir(out)) == 6
    # -c at world 1 continues task A from model_latest (parameters, momentum,
    # step count) for a second epoch, from the model-parallel run's
    # checkpoint as from world 1's: the same parameters
    argv = list(ARGV) + ["-c"]
    argv[argv.index("-num_epochs") + 1] = "2"
    finals = {}
    for layout in ("world1", "mp2"):
        root = tmp_path / layout
        shutil.copytree(runs["root"] / layout, root)
        _interrupt(str(root))
        mp.setenv("RESULTS_FOLDER", str(root))
        assert run_training("base_v2", argv) == 0
        finals[layout] = _final(str(root))
        blob = torch.load(finals[layout] + ".pt", weights_only=True)
        assert (blob["step"], blob["epoch"], blob["optimizer"]["step"]) == (4, 1, 4)
    want, got = _params(finals["world1"]), _params(finals["mp2"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=k)
