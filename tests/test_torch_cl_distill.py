"""The port's distilling trainers, LwF and MiB, and their losses, against the
JAX package's on the CPU, at the widths of ``test_torch_cl_regularizers.py``
(4 -> 16 features, patch 16^3, f32, no augmentation), each run
module-scoped and shared:

  * the four losses (``lwf_distill_loss``, ``unbiased_cross_entropy``,
    ``unbiased_kd_loss``, ``mib_loss``) on seeded logits, the JAX ones
    channels-last, the port's channels-first: values and gradients to
    1e-5;
  * LwF over A, B and a third task C (``freeze_epochs=1``) and MiB over A
    and B, the port from the JAX run's initial parameters: per-epoch losses
    to 1e-4 relative, the body and every head to 1e-4, the earlier heads
    that the joint phase trains included; the body through B's freeze run
    equal to A's bit for bit (``model_freezed``); the manifest's
    ``lwf_phase``, the teachers and the distillation term in the joint
    phase only;
  * resume: B interrupted after its first joint epoch and resumed from its
    ``model_latest`` gives JAX's losses and parameters, with the teachers
    the checkpoint holds (JAX's restore keeps them); the same checkpoint
    without ``cl_state`` rebuilds the teachers from the restored heads, as
    the JAX trainer does; MiB resumed mid-task keeps the teacher its
    checkpoint holds, where the JAX trainer snapshots it again from the
    moved body (its side is given the checkpoint's teacher)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu.ops import losses as jlosses
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import (jax_cl_state_to_torch,
                                                      jax_params_to_state_dict)
from lifelong_nnunet_tpu_torch.ops import cl_losses as pcl
from lifelong_nnunet_tpu_torch.ops.losses import ds_weights
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.restore import restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer
from lifelong_nnunet_tpu_torch.training.trainers.lwf import LwFTrainer
from lifelong_nnunet_tpu_torch.training.trainers.mib import MiBTrainer
from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task

torch.set_num_threads(4)

A, B, C = "Task097_SynthA", "Task098_SynthB", "Task099_SynthC"
KW = dict(num_epochs=2, iters_per_epoch=2, val_iters=1, save_every=1, augment=False,
          patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
TOL = 1e-4
LOSS_TOL = 1e-5
CPU = torch.device("cpu")


# ---------------------------------------------------------------- the losses
def _logits(rng, shape, classes):
    """Channels-last numpy logits and their channels-first port tensor."""
    x = rng.normal(0.0, 2.0, shape + (classes,)).astype(np.float32)
    return x, torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=what)


def _check(jax_fn, port_fn, jax_args, port_args):
    """Value and the gradient of the first argument (or of each in a list)."""
    want, jgrad = jax.value_and_grad(jax_fn)(*jax_args)
    first = port_args[0]
    leaves = first if isinstance(first, list) else [first]
    for t in leaves:
        t.requires_grad_(True)
    got = port_fn(*port_args)
    got.backward()
    _close(got.item(), float(want), "value")
    jleaves = jgrad if isinstance(jgrad, list) else [jgrad]
    for t, g in zip(leaves, jleaves):
        # an input the loss does not reach (weight 0) has no .grad: 0 in JAX
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        _close(np.moveaxis(grad.numpy(), 1, -1), g, "gradient")
    return got.item()


@pytest.mark.parametrize("heads,temperature", [(1, 2.0), (2, 2.0), (2, 0.5)])
def test_lwf_distill_loss_is_jax(heads, temperature):
    rng = np.random.default_rng(heads)
    cur = [_logits(rng, (2, 5, 4, 3), 3) for _ in range(heads)]
    tgt = [_logits(rng, (2, 5, 4, 3), 3) for _ in range(heads)]
    value = _check(lambda c, t: jcl.lwf_distill_loss(c, t, temperature),
                   lambda c, t: pcl.lwf_distill_loss(c, t, temperature),
                   ([jnp.asarray(c) for c, _ in cur], [jnp.asarray(t) for t, _ in tgt]),
                   ([c for _, c in cur], [t for _, t in tgt]))
    # 'batchmean': the sum over voxels and classes over the batch only
    logp = torch.log_softmax(cur[0][1] / temperature, 1)
    logq = torch.log_softmax(tgt[0][1] / temperature, 1)
    one = (logq.exp() * (logq - logp)).sum().item() / 2
    assert value >= one > 0


@pytest.mark.parametrize("old", [1, 2, 3])
def test_unbiased_cross_entropy_is_jax(old):
    rng = np.random.default_rng(10 + old)
    x, xt = _logits(rng, (2, 6, 5), 4)
    target = rng.integers(-1, 4, (2, 6, 5))
    _check(lambda l: jcl.unbiased_cross_entropy(l, jnp.asarray(target), old),
           lambda l: pcl.unbiased_cross_entropy(l, torch.from_numpy(target), old),
           (jnp.asarray(x),), (xt,))


@pytest.mark.parametrize("old,alpha", [(2, 1.0), (3, 0.9), (4, 0.5)])
def test_unbiased_kd_loss_is_jax(old, alpha):
    rng = np.random.default_rng(20 + old)
    x, xt = _logits(rng, (2, 6, 5), 4)
    t, tt = _logits(rng, (2, 6, 5), 4)
    _check(lambda l: jcl.unbiased_kd_loss(l, jnp.asarray(t), old, alpha),
           lambda l: pcl.unbiased_kd_loss(l, tt, old, alpha),
           (jnp.asarray(x),), (xt,))


@pytest.mark.parametrize("outputs", [1, 3])
def test_mib_loss_is_jax(outputs):
    """Deep-supervision weighted: the coarsest output (weight 0) adds
    nothing."""
    rng = np.random.default_rng(30 + outputs)
    factors = [(1, 1, 1), (2, 2, 2), (4, 4, 4)][:outputs]
    shapes = [(2, 8 // f[0], 8 // f[1], 8 // f[2]) for f in factors]
    outs = [_logits(rng, s, 3) for s in shapes]
    teach = [_logits(rng, s, 3) for s in shapes]
    target = rng.integers(0, 3, (2, 8, 8, 8))
    w = ds_weights(outputs)
    tg = jlosses.ds_targets(jnp.asarray(target), factors)
    _check(lambda o: jcl.mib_loss(o, [jnp.asarray(t) for t, _ in teach], None, w, tg,
                                  old_num_classes=3),
           lambda o: pcl.mib_loss(o, [t for _, t in teach], torch.from_numpy(target), w,
                                  factors, old_num_classes=3),
           ([jnp.asarray(o) for o, _ in outs],), ([o for _, o in outs],))


# ---------------------------------------------------------------- the trainers
@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("cl_distill")
    task_c = make_synthetic_task(str(root / "rawc"), task_name=C, num_cases=6, seed=11,
                                 intensity_shift=-0.6)
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b, task_c], str(pre),
                        configs=("3d_fullres",), verbose=False)
    return {"root": root, "jplans": JaxPlans.load(plans_path(str(pre / A))),
            "plans": Plans.load(plans_path(str(pre / A))),
            "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B, C)}}


def _train(trainer, env, folder, tasks):
    for t in tasks:
        trainer.set_output_folder(str(folder / t))
        trainer.train_task(t, env["stage"][t])
    return trainer


class DistillRecording:
    """Records each train step's loss and distillation term (the term None
    where the step has none), in the port's trainers and JAX's."""

    def _build_step(self):
        super()._build_step()
        step = self._train_step
        self.terms = getattr(self, "terms", [])

        def recorded(*args):
            out = step(*args)
            metrics = out[-1]
            self.terms.append((self.mh.active_task, float(metrics["loss"]),
                               {k: float(v) for k, v in metrics.items()
                                if k in ("lwf_distill", "mib")}))
            return out
        self._train_step = recorded


class RecordingLwF(DistillRecording, LwFTrainer):
    pass


class RecordingMiB(DistillRecording, MiBTrainer):
    pass


class RecordingJaxLwF(DistillRecording, jtrainers.LwFTrainer):
    pass


class RecordingJaxMiB(DistillRecording, jtrainers.MiBTrainer):
    pass


# LwF at one step an epoch: its 'batchmean' term sums over voxels, so at
# 16^3 the update after a joint step with a nonzero term moves the model far
# (the term grows from 0.4 to 52 in one step at two steps an epoch), and the
# step after that amplifies f32 roundoff past 1e-4 in either package's
# order of operations (9e-6 at the third joint step, 8e-4 at the fourth).
# One step an epoch keeps every compared step before that point.
LWF_KW = dict(KW, iters_per_epoch=1)
PAIRS = {"lwf": (RecordingJaxLwF, RecordingLwF, (A, B, C), {"freeze_epochs": 1}, LWF_KW),
         "mib": (RecordingJaxMiB, RecordingMiB, (A, B), {}, KW)}


@pytest.fixture(scope="module")
def runs(env):
    """{method: (JAX trainer, port trainer, port folder)}, the port from the
    JAX run's initial parameters."""
    out = {}
    for ext, (jcls, pcls, tasks, hyper, kw) in PAIRS.items():
        jfolder, pfolder = env["root"] / ext / "jax", env["root"] / ext / "port"
        jtr = _train(jcls(env["jplans"], "3d_fullres", str(jfolder / A), JaxOptions(**kw),
                          **hyper), env, jfolder, tasks)
        mh, _, _ = jax_checkpoints.load_checkpoint(str(jfolder / A / "before_training"))
        ptr = pcls(env["plans"], "3d_fullres", str(pfolder / A),
                   TrainerOptions(device="cpu", **kw), **hyper)
        ptr.model.load_state_dict(jax_params_to_state_dict(mh.assemble(), ptr.model))
        out[ext] = (jtr, _train(ptr, env, pfolder, tasks), pfolder)
    return out


def _assert_same_params(jtr, ptr):
    assert ptr.mh.tasks == jtr.mh.tasks
    for t in jtr.mh.tasks:
        want = jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model)
        for name, value in ptr.mh.assemble(t).items():
            assert (value - want[name]).abs().max().item() <= TOL, (t, name)


def _assert_same_losses(plog, jlog):
    assert [(e["task"], e["epoch"]) for e in plog] == [(e["task"], e["epoch"]) for e in jlog]
    for a, b in zip(plog, jlog):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=TOL)


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr, _ = runs[ext]
    _assert_same_losses(ptr._epoch_log, jtr._epoch_log)
    assert ptr.global_step == jtr.global_step
    # every step's loss and distillation term
    assert [(t, sorted(d)) for t, _, d in ptr.terms] == \
        [(t, sorted(d)) for t, _, d in jtr.terms]
    for (_, loss, terms), (_, jloss, jterms) in zip(ptr.terms, jtr.terms):
        np.testing.assert_allclose([loss] + list(terms.values()),
                                   [jloss] + list(jterms.values()), rtol=TOL, atol=1e-6)
    _assert_same_params(jtr, ptr)


def _terms_by_task(trainer, key):
    out = {}
    for task, _, terms in trainer.terms:
        out.setdefault(task, []).append(terms.get(key))
    return out


def test_lwf_epochs_phases_and_distillation(runs):
    """A: 2 plain epochs; B and C: 1 freeze epoch, then 2 joint epochs with
    the distillation term on the joint steps only: 0 on the first (the
    earlier heads and the body are their teachers), > 0 after."""
    _, ptr, _ = runs["lwf"]
    assert [(e["task"], e["epoch"]) for e in ptr._epoch_log] == \
        [(A, 0), (A, 1)] + [(t, e) for t in (B, C) for e in (0, 0, 1)]
    per_task = _terms_by_task(ptr, "lwf_distill")
    assert per_task[A] == [None] * 2
    for t in (B, C):
        freeze, first, later = per_task[t][0], per_task[t][1], per_task[t][2:]
        assert freeze is None and first == 0.0 and len(later) == 1
        assert all(np.isfinite(v) and v > 0 for v in later), later
    assert ptr.global_step == 2 + 2 * 3
    assert list(ptr.cl_state["old_models"]) == [A, B]


def test_lwf_trains_the_earlier_heads_in_the_joint_phase(runs):
    """Heads A and B move through the later joint phases (as JAX's do), and
    C's final checkpoint holds them as the trainer has them."""
    jtr, ptr, folder = runs["lwf"]

    def final(t):
        return checkpoints.load_registry(str(folder / t / "model_final_checkpoint"), CPU, [])[0]

    after_c = final(C)
    for t in (A, B):
        own = final(t).heads[t]
        assert any(not torch.equal(v, ptr.mh.heads[t][k]) for k, v in own.items()), t
        for k, v in after_c.heads[t].items():
            assert torch.equal(v, ptr.mh.heads[t][k]), (t, k)
        want = jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model)
        for k, v in ptr.mh.heads[t].items():
            assert (v - want[k]).abs().max().item() <= TOL, (t, k)


def test_lwf_freeze_run_keeps_the_body_and_records_its_phase(runs):
    _, _, folder = runs["lwf"]
    after_a, _, _ = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                              CPU, [])
    for t, before in ((B, A), (C, B)):
        prev, _, _ = checkpoints.load_registry(str(folder / before / "model_final_checkpoint"),
                                               CPU, [])
        frozen, blob, manifest = checkpoints.load_registry(str(folder / t / "model_freezed"),
                                                           CPU, [])
        assert manifest["lwf_phase"] == 1 and manifest["meta"]["task_order"][-1] == t
        assert all(torch.equal(v, prev.body[k]) for k, v in frozen.body.items()), t
        final, blob, manifest = checkpoints.load_registry(
            str(folder / t / "model_final_checkpoint"), CPU, [])
        assert manifest["lwf_phase"] == 2 and manifest["has_cl_state"]
        assert list(blob["cl_state"]["old_models"]) == manifest["meta"]["task_order"][:-1]
        # before_training is the task's start (phase 1), never the joint phase's
        start, _, manifest = checkpoints.load_registry(str(folder / t / "before_training"),
                                                       CPU, [])
        assert manifest["lwf_phase"] == 1
        assert all(torch.equal(v, after_a.state_init[k]) for k, v in start.heads[t].items())
    _, _, manifest = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                               CPU, [])
    assert manifest["lwf_phase"] == 0


def test_lwf_teachers_are_the_models_at_the_joint_phase_start(runs):
    """C's teachers: the body after C's freeze run (B's) with heads A and B
    as B's final checkpoint holds them; equal to JAX's converted."""
    jtr, ptr, folder = runs["lwf"]
    after_b, _, _ = checkpoints.load_registry(str(folder / B / "model_final_checkpoint"),
                                              CPU, [])
    old = ptr.cl_state["old_models"]
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)["old_models"]
    for t in (A, B):
        for k, v in after_b.assemble(t).items():
            assert torch.equal(old[t][k], v), (t, k)
            assert (old[t][k] - want[t][k]).abs().max().item() <= TOL, (t, k)


def test_mib_distills_from_the_previous_model(runs):
    jtr, ptr, folder = runs["mib"]
    terms = _terms_by_task(ptr, "mib")
    assert terms[A] == [None] * 4
    assert all(v is not None and np.isfinite(v) and v > 0 for v in terms[B]), terms[B]
    after_a, _, _ = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                              CPU, [])
    teacher = ptr.cl_state["teacher"]
    assert all(torch.equal(teacher[k], v) for k, v in after_a.assemble(A).items())
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)["teacher"]
    assert all((teacher[k] - v).abs().max().item() <= TOL for k, v in want.items())
    # heads transfer: B starts at A's trained head
    before_b, blob, _ = checkpoints.load_registry(str(folder / B / "before_training"), CPU, [])
    assert all(torch.equal(v, after_a.heads[A][k]) for k, v in before_b.heads[B].items())
    assert blob["state_init"] == {}


# ---------------------------------------------------------------- resume
def _jax_cl_state(base):
    """A JAX checkpoint's cl_state as its trainer keeps it in memory."""
    _, blob, _ = jax_checkpoints.load_checkpoint(str(base))
    return jax.tree_util.tree_map(jnp.asarray, blob["cl_state"])


def _interrupted(restore, folder, env, task, before):
    """From ``before``'s final checkpoint, ``task`` trained for 1 epoch per
    phase: its ``model_latest`` is the joint phase's first epoch (LwF) or
    the task's first epoch (MiB)."""
    tr = restore(str(folder / before / "model_final_checkpoint"))
    tr.set_output_folder(str(folder / "resume" / task))
    tr.train_task(task, env["stage"][task], num_epochs=1)
    return folder / "resume" / task / "model_latest"


@pytest.fixture(scope="module")
def interrupted(runs, env):
    """{ext: (port model_latest, JAX model_latest)} of B interrupted after
    its first (joint) epoch."""
    out = {}
    for ext, (*_, kw) in PAIRS.items():
        _, _, pfolder = runs[ext]
        jfolder = pfolder.parent / "jax"
        out[ext] = (
            _interrupted(lambda b: restore_trainer(b, TrainerOptions(device="cpu", **kw)),
                         pfolder, env, B, A),
            _interrupted(lambda b: jax_restore_trainer(b, JaxOptions(**kw)), jfolder, env,
                         B, A))
    return out


def _resume_both(ext, port_base, jax_base, env, strip=False):
    kw = PAIRS[ext][-1]
    ptr = restore_trainer(str(port_base), TrainerOptions(device="cpu", **kw), restore_opt=True)
    jtr = jax_restore_trainer(str(jax_base), JaxOptions(**kw), restore_opt=True)
    if strip:
        ptr.cl_state = ptr.init_cl_state()
        jtr.cl_state = jtr.init_cl_state()
    if ext == "mib":
        # the JAX MiB snapshots its teacher again from the registry, whose
        # body moved in B's first epoch; the port keeps the checkpoint's:
        # the JAX side is given that one (it restored it, and keeps it)
        jtr.before_task = lambda task: None
    ptr.train_task(B, env["stage"][B], start_epoch=1)
    jtr.train_task(B, env["stage"][B], start_epoch=1)
    return ptr, jtr


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_mid_task_resume_gives_the_jax_losses(interrupted, env, ext):
    """B resumed at epoch 1 from its ``model_latest`` (LwF: in the joint
    phase) with the optimizer and the teachers the checkpoint holds."""
    port_latest, jax_latest = interrupted[ext]
    mh, blob, manifest = checkpoints.load_registry(str(port_latest), CPU, [])
    if ext == "lwf":
        assert manifest["lwf_phase"] == 2
    key = "old_models" if ext == "lwf" else "teacher"
    held = blob["cl_state"][key]
    held = {A: held} if ext == "mib" else held
    ptr, jtr = _resume_both(ext, port_latest, jax_latest, env)
    assert type(ptr) is get_trainer(ext)
    # JAX's restore keeps the teachers too (flax restores a None template
    # as the stored tree)
    jstate = jax_cl_state_to_torch(_jax_cl_state(jax_latest), jtr.mh.assemble(A),
                                   ptr.model)[key]
    jstate = {A: jstate} if ext == "mib" else jstate
    now = ptr.cl_state[key]
    now = {A: now} if ext == "mib" else now
    for t, sd in held.items():
        for k, v in sd.items():
            assert torch.equal(now[t][k], v), (t, k)
            assert (v - jstate[t][k]).abs().max().item() <= TOL, (t, k)
    # the teachers are not the restored registry's models (its body moved)
    assert any(not torch.equal(held[A][k], v) for k, v in mh.assemble(A).items())
    _assert_same_losses(ptr._epoch_log, jtr._epoch_log)
    assert [e["epoch"] for e in ptr._epoch_log] == [1]
    assert ptr.global_step == jtr.global_step
    _assert_same_params(jtr, ptr)


def test_lwf_resume_without_cl_state_rebuilds_the_teachers(interrupted, env):
    """The joint phase resumed with its ``cl_state`` lost: both packages
    rebuild the teachers from the restored heads (not the phase-start
    snapshots), and agree."""
    port_latest, jax_latest = interrupted["lwf"]
    mh, blob, _ = checkpoints.load_registry(str(port_latest), CPU, [])
    ptr, jtr = _resume_both("lwf", port_latest, jax_latest, env, strip=True)
    rebuilt = ptr.cl_state["old_models"]
    assert list(rebuilt) == [A]
    assert all(torch.equal(rebuilt[A][k], v) for k, v in mh.assemble(A).items())
    assert any(not torch.equal(rebuilt[A][k], v)
               for k, v in blob["cl_state"]["old_models"][A].items())
    _assert_same_losses(ptr._epoch_log, jtr._epoch_log)
    _assert_same_params(jtr, ptr)
