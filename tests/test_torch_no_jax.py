"""The port runs where jax, flax, optax, msgpack and scikit-learn are not
installed (the GPU host has none of them), and imports nothing of the JAX
package ``lifelong_nnunet_tpu``, not even its jax-free modules: a fresh
interpreter whose ``sys.meta_path`` refuses those imports loads every module
of ``lifelong_nnunet_tpu_torch`` (the CT routes' ``ops/kernels/block_pack.py``
and ``ops/kernels/interleave.py``, the evaluation modules and the LwF, MiB,
PLOP / POD and OwnM trainers, the parameter search, the scripts, the
helpers, the cascade, the scale-out layer ``parallel/`` and the C++ patch
gather's binding ``data/native.py`` among them), resolves every ``nnUNet_torch_*``
console script of ``setup.py``, loads ``chip_smoke.py``, runs one tiny CPU
forward through the model and the sliding window (a 3D volume, a 2D patch
over a 3D volume, the volume stream) and one through the CT routes (the
blocked conv and the interleave upsample), and one CPU training run of a
single step through ``run/run_training.py``, one through
``run/run_training_vit.py``, one tiny parameter-search experiment
(``experiment/experiment.py``), ``run/prepare_cascade.py`` on the first
run's checkpoint and one step of the cascade trainer on its stage."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A blocked name is found (torch's own probes with importlib.util.find_spec
# see a spec without an origin) but refuses to load.
BLOCKER = textwrap.dedent("""
    import importlib.machinery, sys

    class Refuse:
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "sklearn",
                   "lifelong_nnunet_tpu")

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.BLOCKED:
                return importlib.machinery.ModuleSpec(name, self)
            return None

        def create_module(self, spec):
            raise ImportError("blocked import of " + spec.name)

        def exec_module(self, module):
            pass

    sys.meta_path.insert(0, Refuse())
""")

SCRIPT = BLOCKER + textwrap.dedent("""
    import importlib, pkgutil
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import lifelong_nnunet_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    new = {"lifelong_nnunet_tpu_torch.ops.kernels." + m for m in ("block_pack", "interleave")}
    new |= {"lifelong_nnunet_tpu_torch." + m for m in (
        "evaluation.cl_metrics", "evaluation.evaluator", "evaluation.evaluator2",
        "inference.postprocessing", "run.run_evaluation", "training.trainers.lwf",
        "training.trainers.mib", "training.trainers.plop", "training.trainers.own",
        "experiment.experiment", "experiment.param_search", "run.run_param_search",
        "utilities.helpful_functions", "scripts.create_split",
        "scripts.dataset_label_mapping", "scripts.delete_tasks", "scripts.join_datasets",
        "scripts.update_checkpoints", "inference.cascade", "run.prepare_cascade",
        "parallel.mesh", "parallel.collectives", "parallel.launch", "data.native")}
    assert new <= set(names), new - set(names)
    import re
    setup = re.sub(r'"\\s*\\n\\s*"', "", open("setup.py").read())
    scripts = re.findall(r"(nnUNet_torch_\\w+) = (lifelong_nnunet_tpu_torch[\\w.]+):(\\w+)",
                         setup)
    for _, module, func in scripts:
        assert callable(getattr(importlib.import_module(module), func)), (module, func)
    want = {"nnUNet_torch_parameter_search", "nnUNet_torch_plan_and_preprocess",
            "nnUNet_torch_dataset_label_mapping", "nnUNet_torch_update_checkpoints",
            "nnUNet_torch_update_checkpoints_all", "nnUNet_torch_delete_tasks",
            "nnUNet_torch_join_datasets", "nnUNet_torch_prepare_cascade"}
    assert want <= {name for name, _, _ in scripts}, want - {n for n, _, _ in scripts}
    import chip_smoke
    from lifelong_nnunet_tpu_torch.inference.sliding_window import predict_sliding_window
    from lifelong_nnunet_tpu_torch.models.unet import GenericUNet
    model = GenericUNet(1, 3, ((2, 2, 2),), ((3, 3, 3),) * 2, 4, 8,
                        deep_supervision=False).eval()
    probs = predict_sliding_window(model, np.ones((10, 9, 8, 1), np.float32), (8, 8, 8), 3,
                                   device=torch.device("cpu"), window_batch=2)
    assert probs.shape == (10, 9, 8, 3) and np.isfinite(probs).all()
    from lifelong_nnunet_tpu_torch.inference.sliding_window import (
        predict_sliding_window_multi)
    flat = GenericUNet(1, 3, ((2, 2),), ((3, 3),) * 2, 4, 8, deep_supervision=False).eval()
    seg = predict_sliding_window(flat, np.ones((3, 9, 8, 1), np.float32), (8, 8), 3,
                                 device=torch.device("cpu"), output="seg")
    assert seg.shape == (3, 9, 8)
    segs = predict_sliding_window_multi(model, [np.ones((10, 9, 8, 1), np.float32)] * 2,
                                        (8, 8, 8), 3, device=torch.device("cpu"),
                                        volume_batch=2)
    assert [s.shape for s in segs] == [(10, 9, 8)] * 2
    ct = GenericUNet(1, 3, ((2, 2, 2),), ((3, 3, 3),) * 2, 2, 4, blocked_conv=True,
                     upsample="interleave").eval()
    assert ct.enc0.block0.route((2, 1, 64, 64, 64)) == "blocked"
    assert ct.interleaved(0, (2, 4, 32, 32, 32))
    with torch.no_grad():
        (out,) = ct(torch.ones((2, 1, 64, 64, 64)))
    assert out.shape == (2, 3, 64, 64, 64) and bool(torch.isfinite(out).all())
    loaded = {m.split(".")[0] for m in sys.modules} & set(Refuse.BLOCKED)
    assert not loaded, loaded
    print("imported", len(names), "modules")
""")


TRAIN_SCRIPT = BLOCKER + textwrap.dedent("""
    import json, os
    import torch
    torch.set_num_threads(1)
    root = sys.argv[1]
    os.environ.update(nnUNet_raw_data_base=os.path.join(root, "raw"),
                      nnUNet_preprocessed=os.path.join(root, "pre"),
                      RESULTS_FOLDER=os.path.join(root, "results"))
    from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
    from lifelong_nnunet_tpu_torch.run.run_training import run_training
    from lifelong_nnunet_tpu_torch.run.run_training_vit import run_training_vit
    from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task
    task_dir = make_synthetic_task(os.path.join(root, "raw", "nnUNet_raw_data"),
                                   num_cases=2, shape=(12, 14, 12))
    plan_and_preprocess([task_dir], os.path.join(root, "pre"), configs=("3d_fullres",),
                        verbose=False)
    run_training("base_v2", ["3d_fullres", "-t", "Task097_SynthA", "-f", "-1",
                             "-num_epochs", "1", "-num_iters", "1", "-val_iters", "1",
                             "-patch_size", "8", "8", "8", "-base_features", "2",
                             "-max_features", "4", "--device", "cpu"])
    run_training_vit(["3d_fullres", "Task097_SynthA", "-1", "-num_epochs", "1",
                      "-num_iters", "1", "-val_iters", "1", "-base_features", "2",
                      "-max_features", "4", "-vit_depth", "1", "--device", "cpu"])
    from lifelong_nnunet_tpu_torch.experiment.experiment import Experiment
    from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path
    from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
    pre_task = os.path.join(root, "pre", "Task097_SynthA")
    stage = os.path.join(pre_task, "nnUNetData_plans_v2.1_3d_fullres")
    res = Experiment("ewc", Plans.load(plans_path(pre_task)), "3d_fullres",
                     {"Task097_SynthA": stage}, os.path.join(root, "search"),
                     {"ewc_lambda": 0.1},
                     TrainerOptions(num_epochs=1, iters_per_epoch=1, val_iters=1,
                                    patch_size=(8, 8, 8), base_num_features=2,
                                    max_num_features=4, fold=-1, device="cpu")).run("exp_0")
    assert os.path.isfile(res["csv"]), res
    from lifelong_nnunet_tpu_torch.inference.cascade import CascadeFullResTrainer
    from lifelong_nnunet_tpu_torch.run import prepare_cascade
    low = [os.path.join(d, "model_final_checkpoint") for d, _, fs in
           os.walk(os.path.join(root, "results")) if "model_final_checkpoint.pt" in fs
           and "Generic_UNet" in d]
    assert prepare_cascade.main(["-t", "97", "-ckpt", low[0], "-lowres_config", "3d_fullres",
                                 "--device", "cpu"]) == 0
    cascade = CascadeFullResTrainer(
        Plans.load(plans_path(pre_task)), "3d_fullres", os.path.join(root, "cascade"),
        TrainerOptions(num_epochs=1, iters_per_epoch=1, val_iters=1, patch_size=(8, 8, 8),
                       base_num_features=2, max_num_features=4, fold=-1, device="cpu"))
    cascade.train_task("Task097_SynthA", prepare_cascade.cascade_stage_dir(
        os.path.join(root, "pre"), "Task097_SynthA"))
    assert cascade.model.enc0.block0.conv.in_channels == 3
    loaded = {m.split(".")[0] for m in sys.modules} & set(Refuse.BLOCKED)
    print(json.dumps({"loaded": sorted(loaded)}))
""")


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 35, proc.stdout


def test_one_train_step_runs_without_jax(tmp_path):
    """``run/run_training.py`` and ``run/run_training_vit.py`` (a ViT-U-Net)
    each take one CPU train step (and its validation batch and
    checkpoints) under the blocker, and so does the cascade trainer on the
    stage ``run/prepare_cascade.py`` writes from the first run."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT, str(tmp_path)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"loaded": []}
    assert len(list(tmp_path.rglob("model_final_checkpoint.pt"))) == 4


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """On a machine without a usable GPU the script exits non-zero and
    prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_to_run_outside_the_repository(tmp_path):
    """A copy of the script in a directory without the packages exits
    non-zero before it touches the device, and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "repository root" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_imports_only_the_port():
    """The script reaches planning, preprocessing, NIfTI I/O, metrics and
    its synthetic task through the port's own modules, never through the JAX
    package, the repository's tests or jax itself."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        source = f.read()
    tree = ast.parse(source)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "lifelong_nnunet_tpu_torch" in roots
    assert not roots & {"lifelong_nnunet_tpu", "tests", "jax", "jaxlib", "flax",
                        "optax", "msgpack", "sklearn"}, roots
    allowed = {"__future__", "json", "math", "os", "shutil", "statistics",
               "subprocess", "sys", "tempfile", "time", "numpy", "torch",
               "lifelong_nnunet_tpu_torch"}
    assert roots <= allowed, roots - allowed
    assert "synthetic.py" not in source and '"tests"' not in source
