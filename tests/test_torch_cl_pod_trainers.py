"""The port's taps and its PLOP and POD trainers against the JAX package's on
the CPU, at the widths of ``test_torch_cl_distill.py`` (4 -> 16 features,
patch 16^3, f32, no augmentation, 2 epochs of 3 steps a task):

  * ``capture_taps`` of the U-Net and of the ViT-U-Net (V1, whose
    bottleneck stage then runs, and V4 with its ``vit_dec*`` taps) against
    JAX's on converted weights; the taps are the stage outputs themselves;
  * PLOP and POD over A, B, the port from the JAX run's initial parameters:
    every step's loss and POD / pseudo-label term to 1e-4, every parameter
    to 1e-4, PLOP's thresholds to 1e-6;
  * PLOP's B interrupted after its first epoch and resumed from its
    ``model_latest`` with the teacher and thresholds the checkpoint holds
    (the JAX side is given them: it would snapshot its teacher again from
    the moved body), and the kept thresholds equal to those the pass gives
    from that teacher;
  * ``nnUNet_torch_train_plop -t A B`` writes the JAX CLI's tree and
    ``nnUNet_torch_inference plop -use_head A`` serves head A.

The JAX side runs with ``local_pod_distance`` replaced, inside this test
process only, by ``tests/test_torch_cl_pod.py:jax_pod_distance_repaired``:
the JAX formula with a zero gradient at a zero norm and the empty regions
left out.  Without it the JAX POD gradient is NaN on every first step of a
new task (the student's taps equal the teacher's), and the JAX trainers'
parameters with it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.models.vit_unet import GenericViTUNet as JaxViTUNet
from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.run.run_training import run_training as jax_run_training
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import (jax_cl_state_to_torch,
                                                      jax_params_to_state_dict)
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet
from lifelong_nnunet_tpu_torch.models.vit_unet import GenericViTUNet
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.restore import restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer
from lifelong_nnunet_tpu_torch.training.trainers.plop import PLOPTrainer, PODTrainer
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image
from tests.test_torch_cl_pod import jax_pod_distance_repaired

torch.set_num_threads(4)

A, B = "Task097_SynthA", "Task098_SynthB"
KW = dict(num_epochs=2, iters_per_epoch=3, val_iters=1, save_every=1, augment=False,
          patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
TOL = 1e-4
THRESHOLD_TOL = 1e-6
CPU = torch.device("cpu")
TERMS = ("pod", "plop_pseudo", "mib_kd", "pseudo_mse", "ewc_penalty")


# ---------------------------------------------------------------- the taps
POOLS = ((2, 2, 2), (2, 2, 2), (1, 2, 1))
CONVS = ((3, 3, 3),) * 4
PATCH = (16, 32, 16)
VIT = dict(vit_embed_dim=16, vit_depth=2, vit_heads=2)


def _cf(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _models(version):
    """(JAX model, its params, the port's model on converted weights, x)."""
    kw = dict(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
              base_num_features=4, max_num_features=16)
    jm = JaxUNet(**kw) if version is None else JaxViTUNet(vit_version=version, **kw, **VIT)
    x = np.random.RandomState(1).normal(size=(2,) + PATCH + (1,)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = GenericUNet(1, 3, POOLS, CONVS, 4, 16) if version is None else \
        GenericViTUNet(1, 3, POOLS, CONVS, PATCH, 4, 16, vit_version=version, **VIT)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return jm, params, tm, x


@pytest.mark.parametrize("version", [None, "V1", "V4"], ids=["unet", "vit_V1", "vit_V4"])
def test_capture_taps_are_jax(version):
    """Every tap JAX returns, channels-first, to 1e-4 + 1e-3 relative (as the
    models' own parity tests); the outputs are those of a forward without
    taps; the ``dec*`` taps are the tensors the decoder stages return."""
    jm, params, tm, x = _models(version)
    j_outs, j_taps = jm.apply({"params": params}, jnp.asarray(x), capture_taps=True)
    with torch.no_grad():
        outs, taps = tm(_cf(x), capture_taps=True)
        plain = tm(_cf(x))
    assert sorted(taps) == sorted(j_taps)
    if version == "V1":
        assert "bottleneck" in taps and "vit" in taps
    if version == "V4":
        assert {f"vit_dec{d}" for d in range(3)} <= set(taps) and "vit" not in taps
    for k, v in taps.items():
        np.testing.assert_allclose(np.moveaxis(v.numpy(), 1, -1), np.asarray(j_taps[k]),
                                   atol=1e-4, rtol=1e-3, err_msg=k)
    for o, p, jo in zip(outs, plain, j_outs):
        assert torch.equal(o, p)
        np.testing.assert_allclose(np.moveaxis(o.numpy(), 1, -1), np.asarray(jo),
                                   atol=1e-4, rtol=1e-3)


def test_v1_runs_its_bottleneck_only_when_taps_are_captured():
    """The serving path (no taps) never runs V1's dead bottleneck stage; a
    forward with taps does, and the POD gradient reaches its parameters."""
    _, _, tm, x = _models("V1")
    calls = []
    tm.bottleneck.register_forward_hook(lambda *_: calls.append(1))
    tm(_cf(x))
    assert calls == []
    outs, taps = tm(_cf(x), capture_taps=True)
    assert calls == [1]
    taps["bottleneck"].float().square().mean().backward()
    assert tm.bottleneck.block1.norm.weight.grad.abs().sum() > 0


# ---------------------------------------------------------------- the trainers
@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("cl_pod")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre),
                        configs=("3d_fullres",), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jcl, "local_pod_distance", jax_pod_distance_repaired)
    yield {"root": root, "pre": pre, "raw": {A: synthetic_task, B: synthetic_task_b},
           "jplans": JaxPlans.load(plans_path(str(pre / A))),
           "plans": Plans.load(plans_path(str(pre / A))),
           "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B)}}
    mp.undo()


class Recording:
    """Records each train step's task, loss and CL terms."""

    def _build_step(self):
        super()._build_step()
        step = self._train_step
        self.terms = getattr(self, "terms", [])

        def recorded(*args):
            out = step(*args)
            metrics = out[-1]
            self.terms.append((self.mh.active_task, float(metrics["loss"]),
                               {k: float(v) for k, v in metrics.items() if k in TERMS}))
            return out
        self._train_step = recorded


def recording(cls):
    return type(f"Recording{cls.__name__}", (Recording, cls), {})


def _train(trainer, env, folder, tasks):
    for t in tasks:
        trainer.set_output_folder(str(folder / t))
        trainer.train_task(t, env["stage"][t])
    return trainer


def train_pair(env, ext, jcls, pcls, tasks, kw, hyper=None, vit=None):
    """(JAX trainer, port trainer, port folder): ``ext`` over ``tasks`` in
    both packages, the port from the JAX run's initial parameters."""
    hyper = hyper or {}
    jfolder, pfolder = env["root"] / ext / "jax", env["root"] / ext / "port"
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if vit:
        jkw.update(vit)
        pkw.update(vit)
    jtr = _train(recording(jcls)(env["jplans"], "3d_fullres", str(jfolder / tasks[0]),
                                 JaxOptions(**jkw), **hyper), env, jfolder, tasks)
    mh, _, _ = jax_checkpoints.load_checkpoint(str(jfolder / tasks[0] / "before_training"))
    ptr = recording(pcls)(env["plans"], "3d_fullres", str(pfolder / tasks[0]),
                          TrainerOptions(**pkw), **hyper)
    ptr.model.load_state_dict(jax_params_to_state_dict(mh.assemble(), ptr.model))
    return jtr, _train(ptr, env, pfolder, tasks), pfolder


def assert_same_params(jtr, ptr, tol=TOL):
    assert ptr.mh.tasks == jtr.mh.tasks
    for t in jtr.mh.tasks:
        want = jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model)
        for name, value in ptr.mh.assemble(t).items():
            assert (value - want[name]).abs().max().item() <= tol, (t, name)


def assert_same_steps(ptr, jtr, tol=TOL):
    """Every step's task, loss and terms."""
    assert [(t, sorted(d)) for t, _, d in ptr.terms] == \
        [(t, sorted(d)) for t, _, d in jtr.terms]
    for (_, loss, terms), (_, jloss, jterms) in zip(ptr.terms, jtr.terms):
        assert np.isfinite(loss) and all(map(np.isfinite, terms.values()))
        np.testing.assert_allclose([loss] + [terms[k] for k in sorted(terms)],
                                   [jloss] + [jterms[k] for k in sorted(terms)],
                                   rtol=tol, atol=1e-6)
    for a, b in zip(ptr._epoch_log, jtr._epoch_log):
        assert (a["task"], a["epoch"]) == (b["task"], b["epoch"])
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=tol)


PAIRS = {"plop": (jtrainers.PLOPTrainer, PLOPTrainer), "pod": (jtrainers.PODTrainer, PODTrainer)}


@pytest.fixture(scope="module")
def runs(env):
    return {ext: train_pair(env, ext, jcls, pcls, (A, B), KW)
            for ext, (jcls, pcls) in PAIRS.items()}


def _thresholds(jtr, ptr):
    """(the port's thresholds, JAX's converted)."""
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)["thresholds"]
    return ptr.cl_state["thresholds"], want


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr, _ = runs[ext]
    assert ptr.global_step == jtr.global_step == 12
    assert_same_steps(ptr, jtr)
    assert_same_params(jtr, ptr)
    keys = {t: sorted(d) for t, _, d in ptr.terms}
    assert keys[A] == [] and keys[B] == (["plop_pseudo", "pod"] if ext == "plop" else ["pod"])
    # the first step of B: the student's taps equal the teacher's
    first_b, *later_b = [d for t, _, d in ptr.terms if t == B]
    assert first_b["pod"] == 0.0 and all(d["pod"] > 0 for d in later_b)
    if ext == "plop":
        assert all(d["plop_pseudo"] > 0 for d in later_b)
    if ext == "plop":
        got, want = _thresholds(jtr, ptr)
        assert len(got) == len(ptr.ds_factors)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (ptr.num_classes,)
            assert (g - w).abs().max().item() <= THRESHOLD_TOL
            assert bool(((g >= 0.001) & (g <= 1.0)).all())
    else:
        assert ptr.cl_state["thresholds"] is None


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_teacher_is_the_model_after_the_previous_task(runs, ext):
    jtr, ptr, folder = runs[ext]
    after_a, _, _ = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                              CPU, [])
    teacher = ptr.cl_state["teacher"]
    assert all(torch.equal(teacher[k], v) for k, v in after_a.assemble(A).items())
    _, blob, manifest = checkpoints.load_registry(str(folder / B / "model_final_checkpoint"),
                                                  CPU, [])
    assert manifest["has_cl_state"] and set(blob["cl_state"]) == {"teacher", "thresholds"}
    before_b, blob, _ = checkpoints.load_registry(str(folder / B / "before_training"), CPU,
                                                  [])
    assert all(torch.equal(v, after_a.heads[A][k]) for k, v in before_b.heads[B].items())
    assert blob["state_init"] == {}


def _jax_cl_state(base):
    _, blob, _ = jax_checkpoints.load_checkpoint(str(base))
    return jax.tree_util.tree_map(jnp.asarray, blob["cl_state"])


def test_plop_mid_task_resume_keeps_the_teacher_and_thresholds(runs, env):
    """B interrupted after its first epoch and resumed at epoch 1 from its
    ``model_latest``: the teacher and thresholds its checkpoint holds (the
    thresholds not computed again; the pass would give them bit for bit),
    JAX's losses and parameters from there."""
    _, _, pfolder = runs["plop"]
    jfolder = pfolder.parent / "jax"
    opts = TrainerOptions(device="cpu", **KW)

    def interrupt(restore, folder):
        tr = restore(str(folder / A / "model_final_checkpoint"))
        tr.set_output_folder(str(folder / "resume" / B))
        tr.train_task(B, env["stage"][B], num_epochs=1)
        return folder / "resume" / B / "model_latest"

    port_latest = interrupt(lambda b: restore_trainer(b, opts), pfolder)
    jax_latest = interrupt(lambda b: jax_restore_trainer(b, JaxOptions(**KW)), jfolder)
    mh, blob, _ = checkpoints.load_registry(str(port_latest), CPU, [])
    held = blob["cl_state"]
    ptr = restore_trainer(str(port_latest), opts, restore_opt=True)
    jtr = jax_restore_trainer(str(jax_latest), JaxOptions(**KW), restore_opt=True)
    assert type(ptr) is get_trainer("plop")
    # the JAX trainer would snapshot its teacher again from the moved body
    # and compute the thresholds from that one: it is given the checkpoint's
    jstate = _jax_cl_state(jax_latest)
    jtr.cl_state = {"teacher": jstate["teacher"],
                    "thresholds": [jnp.asarray(t) for t in
                                   (jstate["thresholds"].values()
                                    if isinstance(jstate["thresholds"], dict)
                                    else jstate["thresholds"])]}
    jtr.before_task = lambda task: None
    ptr.train_task(B, env["stage"][B], start_epoch=1)
    jtr.train_task(B, env["stage"][B], start_epoch=1)
    for k, v in held["teacher"].items():
        assert torch.equal(ptr.cl_state["teacher"][k], v), k
    assert any(not torch.equal(held["teacher"][k], v) for k, v in mh.assemble(A).items())
    for kept, stored in zip(ptr.cl_state["thresholds"], held["thresholds"]):
        assert torch.equal(kept, stored)
    again = ptr.compute_thresholds(B, held["teacher"])
    assert all(torch.equal(a, b) for a, b in zip(again, held["thresholds"]))
    assert [e["epoch"] for e in ptr._epoch_log] == [1]
    for a, b in zip(ptr._epoch_log, jtr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=TOL)
    assert_same_params(jtr, ptr)


# ---------------------------------------------------------------- the CLIs
TINY = ["-num_epochs", "1", "-num_iters", "1", "-val_iters", "1", "-patch_size", "16", "16",
        "16", "-base_features", "4", "-max_features", "16", "--no_augment"]


def _tree(base) -> dict:
    """{dir relative to base: sorted json files}, progress.json and
    model_best left out (as ``test_torch_cl_cli.py``'s)."""
    out = {}
    for d, _, files in os.walk(base):
        out[os.path.relpath(d, base)] = sorted(
            f for f in files if f.endswith(".json")
            and f not in ("progress.json", "model_best.json"))
    return out


def test_plop_cli_writes_the_jax_tree_and_serves_a_head(env, monkeypatch):
    monkeypatch.setenv("nnUNet_raw_data_base", str(env["root"] / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(env["pre"]))
    argv = ["3d_fullres", "-t", "97", "98", "--use_progress_val"] + TINY
    trees = {}
    for side, run in (("jax", jax_run_training), ("port", run_training)):
        monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / f"cli_{side}"))
        assert run("plop", argv + (["--device", "cpu"] if side == "port" else [])) == 0
        trees[side] = _tree(env["root"] / f"cli_{side}" / "nnUNet_ext" / "3d_fullres")
    assert trees["port"] == trees["jax"]
    seq = env["root"] / "cli_port" / "nnUNet_ext" / "3d_fullres" / f"{A}_{B}"
    meta = seq / "metadata" / "nnUNetTrainerPLOP__nnUNetPlansv2.1" / "Generic_UNet" / "SEQ"
    got = json.loads((meta / "plop_trained_on.json").read_text())["0"]
    assert got["finished_training_on"] == [A, B]
    assert got["hyperparams"] == {"pod_lambda": "0.01", "pod_scales": "3"}
    out = env["root"] / "served_a"
    images = os.path.join(env["raw"][A], "imagesTr")
    run_inference(["3d_fullres", "plop", "-i", images, "-o", str(out), "-trained_on", "97",
                   "98", "-use_head", A, "--device", "cpu"])
    cases = sorted(f for f in os.listdir(out) if f.endswith(".nii.gz"))
    assert len(cases) == len([f for f in os.listdir(images) if f.endswith("_0000.nii.gz")])
    seg = np.asarray(read_image(str(out / cases[0])).data)
    assert seg.ndim == 3 and set(np.unique(seg)) <= {0, 1, 2}
