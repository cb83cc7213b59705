"""The port's task-sequence CLIs on the CPU (``--device cpu``), tiny widths
(4 -> 16 features, patch 16^3, no augmentation): ``nnUNet_torch_train_
{sequential,multihead,rehearsal,ewc,rw,frozen_body_seq} -t A B`` write the
JAX CLI's folder and metadata trees (``SEQ``, ``MH``, the JAX folder names
such as ``nnUNetTrainerEWC``, and ``--no_transfer_heads``, which renames
the folder and leaves the trainer transferring heads, as in the JAX
package), with ``cl_state`` in the checkpoints and a frozen body left as
it was; every ``nnUNet_torch_train_*`` script of ``setup.py`` resolves to a
ported trainer; ``-c`` resumes an interrupted task from ``model_latest`` with the
optimizer's own step count, resumes after a finished task with the
MultiHead head taken from ``state_init``, and trains nothing once the
sequence is done; ``--init_seq`` starts from a trained model;
``--disable_saving`` removes the earlier tasks' folders;
``nnUNet_torch_inference <ext> -trained_on A B -use_head X`` serves each
head; a ViT-U-Net trained at a patch other than the plans' is served with
its own patch."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.run.run_training import run_training as jax_run_training
from lifelong_nnunet_tpu_torch.inference.predict import predict_from_folder
from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.run.run_training import run_training
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.restore import restore_model, restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers import TRAINER_MAP, get_trainer
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image

torch.set_num_threads(4)

A, B = "Task097_SynthA", "Task098_SynthB"
SEQ_DIR = f"{A}_{B}"
PLANS = "nnUNetPlansv2.1"
TINY = ["-num_iters", "1", "-val_iters", "1", "-patch_size", "16", "16", "16",
        "-base_features", "4", "-max_features", "16", "--no_augment"]
CPU = ["--device", "cpu"]
CPU_DEVICE = torch.device("cpu")


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("cl_cli")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre),
                        configs=("3d_fullres",), verbose=False)
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_raw_data_base", str(root / "raw"))
    mp.setenv("nnUNet_preprocessed", str(pre))
    yield {"root": root, "raw": {A: synthetic_task, B: synthetic_task_b}}
    mp.undo()


def _results(monkeypatch, env, name):
    """A results root of its own; returns its ``nnUNet_ext/3d_fullres``."""
    monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / name))
    return env["root"] / name / "nnUNet_ext" / "3d_fullres"


def _fold(base, running, trainer, mode, fold=0):
    return base / SEQ_DIR / running / f"{trainer}__{PLANS}" / "Generic_UNet" / mode / \
        f"fold_{fold}"


def _meta(base, trainer, mode):
    return base / SEQ_DIR / "metadata" / f"{trainer}__{PLANS}" / "Generic_UNet" / mode


def _tree(base) -> dict:
    """{dir relative to base: sorted json files} (checkpoint manifests,
    trained-on and validation records; the port's progress.json stands
    for the JAX package's progress.png).  ``model_best`` is left out: it
    is written when the validation loss falls below the best so far, which
    depends on the two runs' own random initial weights."""
    out = {}
    for d, _, files in os.walk(base):
        out[os.path.relpath(d, base)] = sorted(
            f for f in files if f.endswith(".json")
            and f not in ("progress.json", "model_best.json"))
    return out


def _load(base, name):
    return checkpoints.load_registry(str(base / name), CPU_DEVICE, [])


HYPERPARAMS = {"rehearsal": {"samples_in_perc": "0.25"}, "ewc": {"ewc_lambda": "0.4"},
               "rw": {"rw_lambda": "0.4"}}


@pytest.mark.parametrize("ext,extra,trainer,mode", [
    ("sequential", [], "nnUNetTrainerSequential", "SEQ"),
    ("multihead", [], "nnUNetTrainerMultiHead", "MH"),
    ("sequential", ["--no_transfer_heads"], "nnUNetTrainerSequential", "MH"),
    ("rehearsal", [], "nnUNetTrainerRehearsal", "SEQ"),
    ("ewc", [], "nnUNetTrainerEWC", "MH"),
    ("rw", [], "nnUNetTrainerRW", "MH"),
    ("frozen_body_seq", [], "nnUNetTrainerFrozenBody", "SEQ")])
def test_sequence_writes_the_jax_trees(env, monkeypatch, ext, extra, trainer, mode):
    argv = ["3d_fullres", "-t", "97", "98", "-num_epochs", "1", "--use_progress_val"] + \
        TINY + extra
    jax_base = _results(monkeypatch, env, f"jax_{ext}_{mode}")
    assert jax_run_training(ext, argv) == 0
    base = _results(monkeypatch, env, f"port_{ext}_{mode}")
    assert run_training(ext, argv + CPU) == 0
    assert _tree(base) == _tree(jax_base)
    name = f"{ext}_trained_on.json"
    got = json.loads((_meta(base, trainer, mode) / name).read_text())
    want = json.loads((_meta(jax_base, trainer, mode) / name).read_text())
    assert got == want and got["0"]["finished_training_on"] == [A, B]
    final = _fold(base, SEQ_DIR, trainer, mode)
    manifest = json.loads((final / "model_final_checkpoint.json").read_text())
    assert manifest["meta"]["task_order"] == [A, B] and manifest["epoch"] == 0
    assert manifest["hyperparams"] == HYPERPARAMS.get(ext, {})
    history = json.loads((final / "val_metrics.json").read_text())
    # progress validation after A, then after B on both tasks, each with its head
    assert [{t: r["head"] for t, r in h["results"].items()} for h in history] == \
        [{A: A}, {A: A, B: B}]
    # the trainer's class decides head transfer, not --no_transfer_heads:
    # head B starts at the trained head A (Sequential) or at state_init
    transfer = get_trainer(ext).TRANSFER_HEADS
    before_b, blob, _ = _load(final, "before_training")
    final_a, _, _ = _load(_fold(base, A, trainer, mode), "model_final_checkpoint")
    source = final_a.heads[A] if transfer else final_a.state_init
    assert all(torch.equal(v, source[k]) for k, v in before_b.heads[B].items())
    assert (blob["state_init"] == {}) == transfer
    final_b, blob, manifest = _load(final, "model_final_checkpoint")
    assert manifest["has_cl_state"]
    if ext == "ewc":
        assert list(blob["cl_state"]["ewc_tasks"]) == [A, B]
    if ext == "frozen_body_seq":
        # the body froze after A: B's body is A's bit for bit
        assert all(torch.equal(v, final_a.body[k]) for k, v in final_b.body.items())


def test_continue_resumes_an_interrupted_task(env, monkeypatch, capsys):
    """As ``tests/test_cli_e2e.py::test_mid_task_resume``: B interrupted
    after 2 of its epochs, resumed with ``-num_epochs 4 -c`` at epoch 2;
    the optimizer's count runs on from B's own 4 steps (8 at the end),
    the global step from A's 4 and B's (12)."""
    base = _results(monkeypatch, env, "resume")
    argv = ["3d_fullres", "-t", "97", "98", "-num_iters", "2", "-val_iters", "1",
            "-save_interval", "1", "-patch_size", "16", "16", "16", "-base_features", "4",
            "-max_features", "16", "--no_augment"] + CPU
    run_training("sequential", argv + ["-num_epochs", "2"])
    meta = _meta(base, "nnUNetTrainerSequential", "SEQ") / "sequential_trained_on.json"
    m = json.loads(meta.read_text())
    m["0"]["finished_training_on"] = [A]
    m["0"]["start_training_on"] = B
    meta.write_text(json.dumps(m))
    capsys.readouterr()
    run_training("sequential", argv + ["-num_epochs", "4", "-c"])
    assert f"resuming {B} at epoch 2" in capsys.readouterr().out
    final = _fold(base, SEQ_DIR, "nnUNetTrainerSequential", "SEQ")
    man = json.loads((final / "model_final_checkpoint.json").read_text())
    blob = torch.load(final / "model_final_checkpoint.pt", weights_only=True)
    assert man["epoch"] == 3 and blob["step"] == 12 and blob["optimizer"]["step"] == 8
    progress = json.loads((final / "progress.json").read_text())
    assert [e["epoch"] for e in progress["epochs"]] == [2, 3]
    assert json.loads(meta.read_text())["0"]["finished_training_on"] == [A, B]


def test_continue_after_a_task_takes_the_new_head_from_state_init(env, monkeypatch, capsys):
    """``multihead`` interrupted after A: ``-c`` restores A's final
    checkpoint, whose registry keeps ``state_init``, and B's head starts
    there, not at the trained head A.  A second ``-c`` trains nothing."""
    base = _results(monkeypatch, env, "after_a")
    argv = ["3d_fullres", "-t", "97", "98", "-num_epochs", "1"] + TINY + CPU
    run_training("multihead", argv)
    meta = _meta(base, "nnUNetTrainerMultiHead", "MH") / "multihead_trained_on.json"
    m = json.loads(meta.read_text())
    m["0"]["finished_training_on"] = [A]
    m["0"]["finished_validation_on"] = [A]
    meta.write_text(json.dumps(m))
    final = _fold(base, SEQ_DIR, "nnUNetTrainerMultiHead", "MH")
    shutil.rmtree(final)
    capsys.readouterr()
    run_training("multihead", argv + ["-c"])
    assert f"resumed after {A}" in capsys.readouterr().out
    init, _, _ = _load(_fold(base, A, "nnUNetTrainerMultiHead", "MH"), "before_training")
    trained_a, _, _ = _load(_fold(base, A, "nnUNetTrainerMultiHead", "MH"),
                            "model_final_checkpoint")
    before_b, _, _ = _load(final, "before_training")
    assert all(torch.equal(v, init.heads[A][k]) for k, v in before_b.heads[B].items())
    assert not all(torch.equal(v, trained_a.heads[A][k]) for k, v in before_b.heads[B].items())
    assert json.loads(meta.read_text())["0"]["finished_training_on"] == [A, B]

    stamp = {f: os.path.getmtime(final / f) for f in os.listdir(final)}
    capsys.readouterr()
    run_training("multihead", argv + ["-c"])
    assert "finished" not in capsys.readouterr().out
    assert stamp == {f: os.path.getmtime(final / f) for f in os.listdir(final)}


def test_init_seq_starts_from_a_trained_model(env, monkeypatch):
    base = _results(monkeypatch, env, "init_seq")
    run_training("multihead", ["3d_fullres", "-t", "97", "-num_epochs", "1"] + TINY + CPU)
    prev = base / A / A / f"nnUNetTrainerMultiHead__{PLANS}" / "Generic_UNet" / "MH" / \
        "fold_0" / "model_final_checkpoint"
    run_training("multihead", ["3d_fullres", "-t", "98", "-num_epochs", "1", "--init_seq",
                               "-initialize_with_network_trainer", str(prev)] + TINY + CPU)
    folder = base / B / B / f"nnUNetTrainerMultiHead__{PLANS}" / "Generic_UNet" / "MH" / \
        "fold_0"
    init, _, _ = checkpoints.load_registry(str(prev), CPU_DEVICE, [])
    before, _, _ = _load(folder, "before_training")
    assert before.tasks == [A, B]
    for k, v in before.heads[A].items():
        assert torch.equal(v, init.heads[A][k]), k
    for k, v in before.heads[B].items():
        assert torch.equal(v, init.state_init[k]), k
    trainer = restore_trainer(str(folder / "model_final_checkpoint"),
                              TrainerOptions(device="cpu"))
    assert trainer.mh.tasks == [A, B] and type(trainer).__name__ == "MultiHeadTrainer"


def test_disable_saving_removes_the_earlier_folders(env, monkeypatch):
    base = _results(monkeypatch, env, "disable")
    run_training("sequential", ["3d_fullres", "-t", "97", "98", "-num_epochs", "1",
                                "--disable_saving"] + TINY + CPU)
    assert not _fold(base, A, "nnUNetTrainerSequential", "SEQ").exists()
    assert (_fold(base, SEQ_DIR, "nnUNetTrainerSequential", "SEQ")
            / "model_final_checkpoint.pt").is_file()


@pytest.mark.parametrize("ext", ["sequential", "rehearsal"])
def test_use_head_serves_each_head(env, monkeypatch, ext):
    base = _results(monkeypatch, env, f"serve_{ext}")
    run_training(ext, ["3d_fullres", "-t", "97", "98", "-num_epochs", "1"] + TINY + CPU)
    ckpt = str(_fold(base, SEQ_DIR, f"nnUNetTrainer{ext.capitalize()}", "SEQ")
               / "model_final_checkpoint")
    images = os.path.join(env["raw"][A], "imagesTr")
    for head in (A, B):
        out = env["root"] / f"served_{ext}_{head}"
        assert run_inference(["3d_fullres", ext, "-i", images, "-o", str(out),
                              "-trained_on", "97", "98", "-use_head", head,
                              "--disable_tta"] + CPU) == 0
        model, plans, config = restore_model(ckpt, CPU_DEVICE, head=head)
        want = env["root"] / f"direct_{ext}_{head}"
        predict_from_folder([model], plans, config, images, str(want), device=CPU_DEVICE,
                            do_tta=False)
        served = sorted(os.listdir(out))
        assert served == sorted(os.listdir(want)) and len(served) == 6
        for f in served:
            assert np.array_equal(read_image(str(out / f)).data,
                                  read_image(str(want / f)).data), f
    with pytest.raises(KeyError):
        run_inference(["3d_fullres", ext, "-i", images, "-o", str(env["root"] / "never"),
                       "-trained_on", "97", "98", "-use_head", "Task099_C"] + CPU)


def test_vit_trained_at_another_patch_is_served_with_it(env, monkeypatch):
    """A ViT-U-Net's position embeddings are sized for its training patch:
    serving windows with the manifest's patch, not the plans'."""
    _results(monkeypatch, env, "vit_patch")
    plans = Plans.load(plans_path(os.path.join(os.environ["nnUNet_preprocessed"], A)))
    assert tuple(plans.config("3d_fullres").patch_size) != (16, 16, 16)
    run_training("base_v2", ["3d_fullres", "-t", "97", "-num_epochs", "1", "--use_vit",
                             "-vit_depth", "1"] + TINY + CPU)
    out = env["root"] / "served_vit_patch"
    assert run_inference(["3d_fullres", "base_v2", "-i", os.path.join(env["raw"][A], "imagesTr"),
                          "-o", str(out), "-trained_on", "97", "--use_vit",
                          "--disable_tta"] + CPU) == 0
    served = sorted(os.listdir(out))
    assert len(served) == 6
    label = read_image(os.path.join(env["raw"][A], "labelsTr", served[0])).data
    assert read_image(str(out / served[0])).data.shape == label.shape


def test_every_torch_train_script_of_setup_py_resolves(monkeypatch):
    """Each ``nnUNet_torch_train_*`` console script of ``setup.py`` names an
    entry point of the port's CLI whose extension is a ported trainer, and
    every ported sequence trainer has its script; ``body_froz`` is
    ``frozen_body_seq``, as in the JAX package."""
    import runpy

    import setuptools
    from lifelong_nnunet_tpu_torch.run import run_training as cli

    seen = {}
    monkeypatch.setattr(setuptools, "setup", lambda **kw: seen.update(kw))
    runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(__file__)), "setup.py"))
    scripts = dict(line.replace(" ", "").split("=")
                   for line in seen["entry_points"]["console_scripts"])
    train = {name: target for name, target in scripts.items()
             if name.startswith("nnUNet_torch_train_") and name != "nnUNet_torch_train_vit"}
    exts = {}
    for name, target in train.items():
        module, func = target.split(":")
        assert module == "lifelong_nnunet_tpu_torch.run.run_training", name
        assert callable(getattr(cli, func)), name
        exts[name] = func[len("main_"):]
        assert get_trainer(exts[name]) is TRAINER_MAP[exts[name]], name
    assert exts["nnUNet_torch_train_body_froz"] == "frozen_body_seq"
    assert set(exts.values()) == set(TRAINER_MAP) - {"vit_unet"}
