"""The port's own-method trainers OwnM2 and OwnM4 against the JAX package's
on the CPU, at the widths of ``test_torch_cl_pod_trainers.py`` (whose
helpers this uses, the JAX POD repaired in the same way) and 2 epochs of 4
steps a task, so that OwnM4's step counter, which runs on across tasks, hits
its pseudo iteration 13 in B's second epoch:

  * OwnM2 and OwnM4 over A, B from the JAX run's initial parameters: every
    step's loss and its KD / MSE / POD / EWC terms and every parameter to
    1e-4; the EWC anchors of A; OwnM4's counter (16 steps, epoch 4) and the
    weight of its pseudo-label MSE (3.0 on iteration 13 alone, where the
    EWC penalty is dropped);
  * OwnM4's B interrupted after its first epoch and resumed at epoch 1 from
    its ``model_latest`` with the teacher, anchors and counter the
    checkpoint holds (the JAX side given the same by hand);
  * ``nnUNet_torch_train_ownm2 -t A B`` writes the JAX CLI's tree."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.run.run_training import run_training as jax_run_training
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import jax_cl_state_to_torch
from lifelong_nnunet_tpu_torch.ops.cl_losses import QuadraticPenalty
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.restore import restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer
from lifelong_nnunet_tpu_torch.training.trainers.own import OwnM2Trainer, OwnM4Trainer
from tests.test_torch_cl_pod_trainers import (A, B, CPU, KW, TINY, _tree, assert_same_params,
                                              assert_same_steps, env, train_pair)

torch.set_num_threads(4)

__all__ = ["env"]   # the module-scoped fixture, shared

KW4 = dict(KW, iters_per_epoch=4)
PAIRS = {"ownm2": (jtrainers.OwnM2Trainer, OwnM2Trainer),
         "ownm4": (jtrainers.OwnM4Trainer, OwnM4Trainer)}


@pytest.fixture(scope="module")
def runs(env):
    return {ext: train_pair(env, ext, jcls, pcls, (A, B), KW4)
            for ext, (jcls, pcls) in PAIRS.items()}


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr, _ = runs[ext]
    assert ptr.global_step == jtr.global_step == 16
    assert_same_steps(ptr, jtr)
    assert_same_params(jtr, ptr)
    keys = {t: sorted(d) for t, _, d in ptr.terms}
    assert keys[A] == [] and keys[B] == (["ewc_penalty", "mib_kd", "pod"] if ext == "ownm2"
                                         else ["pod", "pseudo_mse"])
    first_b = next(d for t, _, d in ptr.terms if t == B)
    assert first_b["pod"] == 0.0
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)
    assert list(ptr.cl_state["ewc_tasks"]) == list(want["ewc_tasks"]) == [A, B]
    for part in ("fisher", "params"):
        got, ref = ptr.cl_state["ewc_tasks"][A][part], want["ewc_tasks"][A][part]
        assert sorted(got) == sorted(ref) == sorted(dict(ptr.model.named_parameters()))
        for k, v in got.items():
            assert v.dtype == torch.bfloat16
            assert (v.float() - ref[k].float()).abs().max().item() <= \
                2e-2 * max(ref[k].float().abs().max().item(), 1e-3), (part, k)


def test_ownm4_counter_runs_on_across_tasks(runs):
    """The JAX counter is set up with the trainer, not per task: after A
    (8 steps) and B (8 more) it stands at 16, epoch 4, in both packages.  B
    sees iterations 8-15; only 13 is a pseudo iteration, at ramp weight
    pseudo_alpha (epoch 3 of E = 2: past E - E/10)."""
    jtr, ptr, _ = runs["ownm4"]
    assert (ptr.cl_state["iter"], ptr.cl_state["epoch"]) == (16, 4)
    assert (int(jtr.cl_state["iter"]), int(jtr.cl_state["epoch"])) == (16, 4)
    converted = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)
    assert (converted["iter"], converted["epoch"]) == (16, 4)
    assert set(converted) == set(ptr.cl_state)
    weights = [ptr.pseudo_weight(i, i // 4) for i in range(16)]
    # iteration 0 is a pseudo iteration too, at epoch 0, where the ramp is 0
    assert weights == [3.0 if i == 13 else 0.0 for i in range(16)]
    assert ptr.pseudo_weight(13, 0) == 0.0


def _jax_cl_state(base):
    _, blob, _ = jax_checkpoints.load_checkpoint(str(base))
    return jax.tree_util.tree_map(jnp.asarray, blob["cl_state"])


def test_ownm4_mid_task_resume_keeps_its_state(runs, env):
    _, _, pfolder = runs["ownm4"]
    jfolder = pfolder.parent / "jax"
    opts = TrainerOptions(device="cpu", **KW4)

    def interrupt(restore, folder):
        tr = restore(str(folder / A / "model_final_checkpoint"))
        if restore is jax_restore:
            # the JAX restore drops the EWC anchors: given by hand
            tr.cl_state = dict(_jax_cl_state(folder / A / "model_final_checkpoint"))
        tr.set_output_folder(str(folder / "resume" / B))
        tr.train_task(B, env["stage"][B], num_epochs=1)
        return folder / "resume" / B / "model_latest"

    def jax_restore(base):
        return jax_restore_trainer(base, JaxOptions(**KW4))

    port_latest = interrupt(lambda b: restore_trainer(b, opts), pfolder)
    jax_latest = interrupt(jax_restore, jfolder)
    mh, blob, _ = checkpoints.load_registry(str(port_latest), CPU, [])
    held = blob["cl_state"]
    assert (held["iter"], held["epoch"]) == (12, 3) and list(held["ewc_tasks"]) == [A]
    ptr = restore_trainer(str(port_latest), opts, restore_opt=True)
    jtr = jax_restore_trainer(str(jax_latest), JaxOptions(**KW4), restore_opt=True)
    assert type(ptr) is get_trainer("ownm4")
    # the JAX restore drops the anchors and the JAX trainer would snapshot
    # its teacher again from the moved body: it is given the checkpoint's
    jtr.cl_state = dict(_jax_cl_state(jax_latest))
    jtr.before_task = lambda task: None
    ptr.train_task(B, env["stage"][B], start_epoch=1)
    jtr.train_task(B, env["stage"][B], start_epoch=1)
    for k, v in held["teacher"].items():
        assert torch.equal(ptr.cl_state["teacher"][k], v), k
    assert any(not torch.equal(held["teacher"][k], v) for k, v in mh.assemble(A).items())
    assert ptr.cl_state["iter"] == int(jtr.cl_state["iter"]) == 16
    # the resumed epoch (iterations 12-15) holds the pseudo iteration 13
    assert [e["epoch"] for e in ptr._epoch_log] == [1]
    assert ptr.step_losses and all(map(np.isfinite, ptr.step_losses))
    for a, b in zip(ptr._epoch_log, jtr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=1e-4)
    assert_same_params(jtr, ptr)


def test_ownm2_cli_writes_the_jax_tree(env, monkeypatch):
    monkeypatch.setenv("nnUNet_raw_data_base", str(env["root"] / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(env["pre"]))
    argv = ["3d_fullres", "-t", "97", "98"] + TINY
    trees = {}
    for side, run in (("jax", jax_run_training), ("port", run_training)):
        monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / f"ownm2_cli_{side}"))
        assert run("ownm2", argv + (["--device", "cpu"] if side == "port" else [])) == 0
        trees[side] = _tree(env["root"] / f"ownm2_cli_{side}" / "nnUNet_ext" / "3d_fullres")
    assert trees["port"] == trees["jax"]
    meta = (env["root"] / "ownm2_cli_port" / "nnUNet_ext" / "3d_fullres" / f"{A}_{B}" /
            "metadata" / "nnUNetTrainerOwnM2__nnUNetPlansv2.1" / "Generic_UNet" / "SEQ")
    got = json.loads((meta / "ownm2_trained_on.json").read_text())["0"]
    assert got["finished_training_on"] == [A, B]
    # the port keeps every METHOD_ARGS value in the manifest, so -c trains on
    # with them (the JAX trainer keeps mib_alpha, mib_lkd and ewc_lambda)
    assert got["hyperparams"] == {"mib_alpha": "1.0", "mib_lkd": "10.0", "pod_lambda": "0.01",
                                  "pod_scales": "3", "ewc_lambda": "0.4"}


def test_ewc_on_the_vit_of_a_unet_is_zero():
    """OwnM1 (EWC on the ViT's parameters) trained on a U-Net keeps anchors
    of no parameter: the penalty is 0 and adds no gradient, as the JAX
    package's sum over an empty mask."""
    named = {"enc0.w": torch.nn.Parameter(torch.ones(3))}
    pen = QuadraticPenalty(named, [{"weight": {}, "params": {}}] * 2, 0.4)
    value, terms = pen()
    pen.add_grad()
    assert float(value) == 0.0 and terms == {"penalty": value}
    assert named["enc0.w"].grad is None
