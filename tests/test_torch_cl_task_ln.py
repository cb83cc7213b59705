"""The port's trainers with task-specific ViT LayerNorms against the JAX
package's on the CPU, f32: a two-task ``MultiHeadTrainer`` and an
``EWCLNTrainer`` on the ViT-U-Net (V1, depth 1) with
``vit_task_specific_ln``, 1 epoch of 2 steps a task (patch 16^3, widths 4
-> 16, no augmentation), the port from the JAX run's initial parameters:
every step's loss to 1e-4, every parameter to 1e-4, the registry's keys
equal to JAX's under the converter, the manifest's ``ln_tasks`` /
``active_task_idx``; ``ln_A`` after B moved by weight decay alone;
EWC-LN's anchors of A on ``ln_A`` keys only; a restored trainer and a
served head (``restore_model(..., head=A)``) giving JAX's output for that
head.  Each tolerance is stated where it is used."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.training.restore import restore_model, restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import MultiHeadTrainer, TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers.ewc import EWCLNTrainer
from tests.test_torch_cl_pod_trainers import (A, B, KW, assert_same_params, assert_same_steps,
                                              env, recording)

torch.set_num_threads(4)

__all__ = ["env"]   # the module-scoped fixture, shared

VIT_LN = dict(use_vit=True, vit_depth_override=1, vit_task_specific_ln=True)
KW_LN = dict(KW, num_epochs=1, iters_per_epoch=2, **VIT_LN)
PAIRS = {"multihead": (jtrainers.MultiHeadTrainer, MultiHeadTrainer),
         "ewc_ln": (jtrainers.EWCLNTrainer, EWCLNTrainer)}


def _train(trainer, env, folder, tasks):
    for t in tasks:
        trainer.set_output_folder(str(folder / t))
        trainer.train_task(t, env["stage"][t])
    return trainer


@pytest.fixture(scope="module")
def runs(env):
    """{ext: (JAX trainer, port trainer, port folder, jax folder, port's
    registry after A)}: both over A, B, the port from the JAX run's initial
    parameters (its ``ln_A`` set already made, as JAX's before_training
    holds it)."""
    out = {}
    for ext, (jcls, pcls) in PAIRS.items():
        jfolder, pfolder = env["root"] / f"ln_{ext}" / "jax", env["root"] / f"ln_{ext}" / "port"
        jtr = _train(recording(jcls)(env["jplans"], "3d_fullres", str(jfolder / A),
                                     JaxOptions(**KW_LN)), env, jfolder, (A, B))
        mh, _, _ = jax_checkpoints.load_checkpoint(str(jfolder / A / "before_training"))
        ptr = recording(pcls)(env["plans"], "3d_fullres", str(pfolder / A),
                              TrainerOptions(device="cpu", **KW_LN))
        ptr.set_vit_task_lns((A,), 0)
        ptr.model.load_state_dict(jax_params_to_state_dict(mh.assemble(), ptr.model))
        _train(ptr, env, pfolder, (A,))
        after_a = {k: v.clone() for k, v in ptr.mh.body.items()}
        _train(ptr, env, pfolder, (B,))
        out[ext] = (jtr, ptr, pfolder, jfolder, after_a)
    return out


def _ln_keys(keys, task):
    return sorted(k for k in keys if f".ln.{task}." in k)


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_task_ln_trainers_match_jax(runs, ext):
    """Losses of every step and epoch and every parameter of both heads to
    1e-4 (``assert_same_steps`` / ``assert_same_params``); the registry's
    keys JAX's under the converter: one LayerNorm set per task in every
    block's norm1, norm2 and the final norm, no single set; the manifest's
    ``vit`` entry."""
    jtr, ptr, folder, _, _ = runs[ext]
    assert ptr.global_step == jtr.global_step == 4
    assert_same_steps(ptr, jtr)
    assert_same_params(jtr, ptr)
    assert ptr.model.ln_tasks == (A, B) and ptr.model.active_task_idx == 1
    for t in (A, B):
        keys = set(ptr.mh.assemble(t))
        assert keys == set(jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model))
        assert len(_ln_keys(keys, A)) == len(_ln_keys(keys, B)) == 6
        assert not [k for k in keys if k.startswith("vit.") and "norm" in k
                    and ".ln." not in k and "patch_embed" not in k]
    manifest = json.loads((folder / B / "model_final_checkpoint.json").read_text())
    jman = json.loads((runs[ext][3] / B / "model_final_checkpoint.json").read_text())
    for key in ("task_specific_ln", "ln_tasks", "active_task_idx"):
        assert manifest["vit"][key] == jman["vit"][key], key
    assert manifest["vit"]["ln_tasks"] == [A, B] and manifest["vit"]["active_task_idx"] == 1
    first = json.loads((folder / A / "model_final_checkpoint.json").read_text())
    assert first["vit"]["ln_tasks"] == [A] and first["vit"]["active_task_idx"] == 0


def test_ln_a_moves_by_weight_decay_alone_through_b(runs):
    """The multi-head trainer's ``ln_A`` set gets no gradient on B: each
    tensor after B is the after-A tensor under PolySGD's weight decay
    (3e-5) and Nesterov momentum (0.99) alone at B's learning rates,
    computed here in f64, to 1e-7 absolute (f32 roundoff of ~1e-6 of a
    change)."""
    _, ptr, _, _, after_a = runs["multihead"]
    keys = _ln_keys(after_a, A)
    assert keys
    steps, lr = KW_LN["iters_per_epoch"], 1e-2       # epoch 0 of B: the poly LR is lr0
    for k in keys:
        p = after_a[k].double()
        buf = None
        for _ in range(steps):
            g = 3e-5 * p
            buf = g if buf is None else 0.99 * buf + g
            p = p - lr * (g + 0.99 * buf)
        got = ptr.mh.body[k].double()
        assert (got - p).abs().max().item() <= 1e-7, k
        assert not torch.equal(got, after_a[k].double()) or not after_a[k].any(), k


def test_ewc_ln_anchors_a_on_ln_a_only(runs):
    """EWC-LN's anchors of A are the ViT's LayerNorm tensors of ``ln_A``
    (the only set the model had), B's those of both sets."""
    _, ptr, _, _, _ = runs["ewc_ln"]
    anchors = {t: sorted(s["params"]) for t, s in ptr.cl_state["ewc_tasks"].items()}
    names = list(dict(ptr.model.named_parameters()))
    assert anchors[A] == _ln_keys(names, A)
    assert anchors[B] == sorted(_ln_keys(names, A) + _ln_keys(names, B))


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_restore_and_serve_each_head_as_jax(runs, ext):
    """``restore_trainer`` rebuilds the manifest's sets and index and the
    registry bit for bit; ``restore_model(..., head=X)`` (what serving
    loads) gives JAX's restored model's full-resolution output for head X,
    both with the last task's LayerNorms (JAX serves every head so), to
    1e-4 + 1e-3 relative."""
    jtr, ptr, folder, jfolder, _ = runs[ext]
    base = str(folder / B / "model_final_checkpoint")
    tr = restore_trainer(base, TrainerOptions(device="cpu"))
    assert (tr.model.ln_tasks, tr.model.active_task_idx) == ((A, B), 1)
    for t in (A, B):
        assert all(torch.equal(v, ptr.mh.assemble(t)[k]) for k, v in tr.mh.assemble(t).items())
    jtr2 = jax_restore_trainer(str(jfolder / B / "model_final_checkpoint"))
    x = np.random.RandomState(5).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    for head in (A, B):
        model, _, _ = restore_model(base, torch.device("cpu"), head=head)
        assert (model.ln_tasks, model.active_task_idx) == ((A, B), 1)
        with torch.no_grad():
            (out,) = model(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
        want = jtr2.model.apply({"params": jtr2.mh.assemble(head)}, jnp.asarray(x))[0]
        np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(want),
                                   atol=1e-4, rtol=1e-3, err_msg=head)
    assert math.isfinite(float(np.asarray(want).sum()))
