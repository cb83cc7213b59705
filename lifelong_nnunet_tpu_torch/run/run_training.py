"""CLI: continual training across a task sequence with the PyTorch port —
``nnUNet_torch_train_<extension>`` for every trainer of the port's
registry (``training/trainers/__init__.py``): ``multihead``,
``sequential``, ``rehearsal``, ``base_v2``, the EWC family (``ewc``,
``ewc_vit``, ``ewc_unet``, ``ewc_ln``: ``-ewc_lambda``), ``rw``
(``-rw_lambda``, ``-rw_alpha``, ``-fisher_update_after``), the freezing
trainers (``frozen_vit``, ``frozen_nonln``, ``frozen_unet``,
``frozen_body_seq``, ``froz_ewc``: ``-ewc_lambda``, ``--adaptive``), the
distilling trainers ``lwf`` (``-lwf_temperature``) and ``mib``
(``-mib_alpha``, ``-mib_lkd``), ``plop`` and ``pod`` (``-pod_lambda``,
``-pod_scales``) and the own-method trainers ``ownm1``-``ownm3``
(``-mib_alpha``, ``-mib_lkd``, ``-pod_lambda``, ``-pod_scales``,
``-ewc_lambda``) and ``ownm4`` (``-pseudo_alpha``, ``-pod_lambda``,
``-pod_scales``, ``-ewc_lambda``).

The JAX package's ``nnUNet_train_<method>``
(``lifelong_nnunet_tpu/run/run_training.py``), with ``--device`` (default
``cuda``, never falling back to the CPU) in place of its ``-d`` list: the
fold x task loop, one output folder per task prefix and the metadata
folder (``training/output_paths.py``), ``-c`` continuation (mid-task from
``model_latest`` at its epoch + 1, or after the last finished task of
``<extension>_trained_on.json``), ``--init_seq`` with
``-initialize_with_network_trainer``, ``--disable_saving``, ``-val_mode``
and ``--use_progress_val``, and the per-method hyperparameters of
``METHOD_ARGS``.  Every task is trained with the first task's plans.
``--no_transfer_heads`` changes only the folder (``SEQ`` -> ``MH``), as in
the JAX CLI: the trainer still follows its class's ``TRANSFER_HEADS``.
``-n_devices N [-model_parallel M]`` trains over N devices, N / M data x M
model (``parallel/``): run normally, the CLI refuses what the JAX trainer
refuses (more devices than are visible, an M that does not divide N), then
spawns N ranks, one a device (``cuda:0`` ... ``cuda:N-1``, or N on the CPU
with ``--device cpu``), which meet at a file under ``RESULTS_FOLDER`` and
each run the fold loop; under ``torchrun`` (``WORLD_SIZE`` set) it joins
the group it was given instead, one rank a process.  The cascade's fullres stage
(``CascadeFullResTrainer``, ``inference/cascade.py``, on the stage that
``nnUNet_torch_prepare_cascade`` writes) trains through the trainer API,
as in the JAX package, which has no training CLI for it.  ``--use_vit``
trains the ViT-U-Net (``-v``, ``-v_type``, ``--do_LSA``, ``--do_SPT``,
``-vit_depth``, ``--task_specific_ln``: one LayerNorm set per task) into
the ``Generic_ViT_UNetV{v}/...`` folder of the JAX CLI (``task_specific``
with ``--task_specific_ln``).  ``--remat`` recomputes the U-Net's stages
in the backward (no effect on the ViT-U-Net, as in JAX).  ``--no_pallas_conv`` trains on the plain route (no hand-written
kernels).

The trained model is served by ``nnUNet_torch_inference <network>
<extension> -trained_on <tasks> [-use_head <task>]`` and scored by
``nnUNet_torch_evaluate`` / ``nnUNet_torch_evaluate2`` with the same
arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch
import torch.distributed as dist

from .. import paths
from ..device import resolve_device
from ..parallel.launch import in_torchrun, join_torchrun, spawn
from ..parallel.mesh import check_devices, visible_devices
from ..planning.plans import Plans, plans_path
from ..training.output_paths import build_output_folder, metadata_folder
from ..training.restore import find_checkpoint, restore_trainer
from ..training.trainer import TrainerOptions
from ..training.trainers import TRAINER_MAP, get_trainer
from .plan_and_preprocess import resolve_task

# per-method CLI hyperparameters of the ported trainers: flag -> (type,
# default) (the JAX CLI's METHOD_ARGS); a bool is a store_true switch
METHOD_ARGS = {
    "rehearsal": {"samples_in_perc": (float, 0.25)},
    "ewc": {"ewc_lambda": (float, 0.4)},
    "ewc_vit": {"ewc_lambda": (float, 0.4)},
    "ewc_unet": {"ewc_lambda": (float, 0.4)},
    "ewc_ln": {"ewc_lambda": (float, 0.4)},
    "froz_ewc": {"ewc_lambda": (float, 0.4), "adaptive": (bool, False)},
    "rw": {"rw_lambda": (float, 0.4), "rw_alpha": (float, 0.9),
           "fisher_update_after": (int, 10)},
    "lwf": {"lwf_temperature": (float, 2.0)},
    "mib": {"mib_alpha": (float, 0.9), "mib_lkd": (float, 10.0)},
    "plop": {"pod_lambda": (float, 1e-2), "pod_scales": (int, 3)},
    "pod": {"pod_lambda": (float, 1e-2), "pod_scales": (int, 3)},
    **{ext: {"mib_alpha": (float, 1.0), "mib_lkd": (float, 10.0),
             "pod_lambda": (float, 1e-2), "pod_scales": (int, 3),
             "ewc_lambda": (float, 0.4)} for ext in ("ownm1", "ownm2", "ownm3")},
    "ownm4": {"pseudo_alpha": (float, 3.0), "pod_lambda": (float, 1e-2),
              "pod_scales": (int, 3), "ewc_lambda": (float, 0.4)},
}

# the JAX CLI's folder names, nnUNetTrainer<name> (its ``_camel``)
TRAINER_NAMES = {
    "ewc_vit": "EWCViT", "ewc_unet": "EWCUNet", "ewc_ln": "EWCLN", "ewc": "EWC",
    "rw": "RW", "lwf": "LWF", "mib": "MiB", "plop": "PLOP", "pod": "POD",
    "froz_ewc": "FrozEWC", "frozen_vit": "FrozenViT", "frozen_nonln": "FrozenNonLN",
    "frozen_unet": "FrozenUNet", "frozen_body_seq": "FrozenBody", "ownm1": "OwnM1",
    "ownm2": "OwnM2", "ownm3": "OwnM3", "ownm4": "OwnM4", "multihead": "MultiHead",
    "sequential": "Sequential", "rehearsal": "Rehearsal"}

def build_parser(extension: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"Training with the PyTorch port: {extension}")
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("-t", "--task_ids", nargs="+", required=True,
                   help="ordered task sequence (ids or names)")
    p.add_argument("-f", "--folds", nargs="+", type=int, default=[0])
    p.add_argument("-s", "--split_at", default="seg_outputs")
    p.add_argument("-num_epochs", type=int, default=100)
    p.add_argument("-save_interval", type=int, default=25)
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("-c", "--continue_training", action="store_true")
    p.add_argument("--init_seq", action="store_true",
                   help="initialize the first task from a previous trainer's checkpoint")
    p.add_argument("-initialize_with_network_trainer", default=None,
                   help="checkpoint base path (without extension) to initialize from")
    p.add_argument("--no_transfer_heads", action="store_true",
                   help="the MH folder instead of SEQ (the trainer is unchanged)")
    p.add_argument("--disable_saving", action="store_true",
                   help="delete the earlier tasks' folders at the end")
    p.add_argument("-val_mode", choices=["sliding_window", "patches"],
                   default="sliding_window")
    p.add_argument("--use_progress_val", action="store_true",
                   help="run cross-task validation every save_interval epochs")
    p.add_argument("--fp32", action="store_true", help="disable bfloat16 compute")
    p.add_argument("-num_iters", type=int, default=250)
    p.add_argument("-val_iters", type=int, default=50)
    p.add_argument("--use_vit", action="store_true")
    p.add_argument("-v", "--vit_version", type=int, default=1, choices=[1, 2, 3, 4])
    p.add_argument("-v_type", "--vit_type", default="base",
                   choices=["base", "large", "huge"])
    p.add_argument("--task_specific_ln", action="store_true")
    p.add_argument("--do_LSA", action="store_true")
    p.add_argument("--do_SPT", action="store_true")
    p.add_argument("-patch_size", nargs="+", type=int, default=None)
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-base_features", type=int, default=None)
    p.add_argument("-max_features", type=int, default=None)
    p.add_argument("-vit_depth", type=int, default=None)
    p.add_argument("-n_devices", type=int, default=None,
                   help="data-parallel devices (SPMD mesh; batch is sharded)")
    p.add_argument("-model_parallel", type=int, default=1,
                   help="shard conv/dense feature dims over this many of the "
                        "n_devices (mesh = data x model; replaces the "
                        "reference's --use_mult_gpus split_gpu)")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no_pallas_conv", dest="use_kernels", action="store_false",
                   help="train on the plain route, without the hand-written kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda', 'cuda:N' or 'cpu')")
    for name, (typ, default) in METHOD_ARGS.get(extension, {}).items():
        if typ is bool:
            p.add_argument(f"--{name}", action="store_true", default=default)
        else:
            p.add_argument(f"-{name}", f"--{name}", type=typ, default=default)
    return p


def stage_dir_for(pre_root: str, task_name: str, config: str,
                  data_identifier: str = paths.default_data_identifier) -> str:
    d = os.path.join(pre_root, task_name, f"{data_identifier}_{config}")
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"{d} missing — run nnUNet_plan_and_preprocess -t {task_name} first")
    return d


def trainer_name(extension: str) -> str:
    """The JAX CLI's ``nnUNetTrainer<Ext>`` folder name (its ``_camel``)."""
    return f"nnUNetTrainer{TRAINER_NAMES.get(extension, extension.capitalize())}"


def arch_kwargs(args) -> dict:
    """The ``arch_dir`` options of parsed CLI arguments."""
    return dict(vit=args.use_vit, vit_version=f"V{args.vit_version}",
                vit_type=args.vit_type, task_specific_ln=args.task_specific_ln,
                spt=args.do_SPT, lsa=args.do_LSA)


def output_folder(results: str, network: str, task: str, extension: str,
                  plans_identifier: str, fold: int, transfer_heads: bool,
                  **arch) -> str:
    """The folder of a single-task run."""
    return build_output_folder(results, network, [task], [task], trainer_name(extension),
                               plans_identifier, fold, transfer_heads, **arch)


def _resume(tasks, opts, meta_dir, extension, fold, folder):
    """``-c``: (trainer or None, tasks finished, task to resume, its first
    epoch) from the metadata folder's manifest."""
    manifest_file = os.path.join(meta_dir, f"{extension}_trained_on.json")
    if not os.path.isfile(manifest_file):
        return None, [], None, 0
    with open(manifest_file) as f:
        trained_on = json.load(f).get(str(fold), {})
    finished = trained_on.get("finished_training_on", [])
    in_progress = trained_on.get("start_training_on")
    if in_progress and in_progress in tasks:
        # an interrupted task: continue it from model_latest (parameters,
        # optimizer momentum and step count, epoch)
        ckpt = find_checkpoint(folder(in_progress), prefer="model_latest")
        if ckpt and ckpt.endswith("model_latest"):
            trainer = restore_trainer(ckpt, opts, restore_opt=True)
            trainer.already_trained_on = {str(fold): trained_on}
            print(f"[fold {fold}] resuming {in_progress} at epoch {trainer.epoch + 1} "
                  f"from {ckpt}")
            return trainer, finished, in_progress, trainer.epoch + 1
    if finished:
        ckpt = find_checkpoint(folder(finished[-1]))
        if ckpt:
            trainer = restore_trainer(ckpt, opts)
            trainer.already_trained_on = {str(fold): trained_on}
            print(f"[fold {fold}] resumed after {finished[-1]} from {ckpt}")
            return trainer, finished, None, 0
    return None, finished, None, 0


def run_training(extension: str, argv=None) -> int:
    args = build_parser(extension).parse_args(argv)
    n = args.n_devices or 1
    if n > 1 and not dist.is_initialized():
        device_type = torch.device(args.device).type
        if in_torchrun():
            return _train(extension, args, str(join_torchrun(device_type)))
        check_devices(n, args.model_parallel, visible_devices(device_type))
        if device_type == "cuda":
            resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(n)] if device_type == "cuda" else ["cpu"] * n
        return spawn(_rank_main, (extension, list(argv) if argv is not None else sys.argv[1:]),
                     devices, rdzv_dir=paths.require(paths.results_dir(), "results"))
    return _train(extension, args, args.device)


def _rank_main(device: str, extension: str, argv) -> int:
    """One spawned rank of ``-n_devices``: the fold loop on ``device``."""
    return _train(extension, build_parser(extension).parse_args(argv), device)


def _train(extension: str, args, device: str) -> int:
    trainer_cls = get_trainer(extension)
    raw = paths.raw_data_dir(create=False)
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    results = paths.require(paths.results_dir(), "results")
    tasks = []
    for t in args.task_ids:
        try:
            tasks.append(os.path.basename(resolve_task(t, pre)))
        except FileNotFoundError:
            tasks.append(os.path.basename(resolve_task(t, raw or pre)))
    name = trainer_name(extension)
    # one Plans object for the whole sequence: the first task's
    first_plans = Plans.load(plans_path(os.path.join(pre, tasks[0]), args.plans_identifier))
    hyper = {k: getattr(args, k) for k in METHOD_ARGS.get(extension, {})}
    transfer = trainer_cls.TRANSFER_HEADS and not args.no_transfer_heads
    arch = arch_kwargs(args)

    for fold in args.folds:
        opts = TrainerOptions(
            num_epochs=args.num_epochs, iters_per_epoch=args.num_iters,
            val_iters=args.val_iters, save_every=args.save_interval,
            split_at=args.split_at, fold=fold,
            dtype="float32" if args.fp32 else "bfloat16",
            use_progress_val=args.use_progress_val, val_mode=args.val_mode,
            patch_size=tuple(args.patch_size) if args.patch_size else None,
            batch_size=args.batch_size, augment=not args.no_augment,
            base_num_features=args.base_features, max_num_features=args.max_features,
            device=device, use_kernels=args.use_kernels, use_vit=args.use_vit,
            vit_version=f"V{args.vit_version}", vit_type=args.vit_type,
            vit_lsa=args.do_LSA, vit_spt=args.do_SPT,
            vit_task_specific_ln=args.task_specific_ln, vit_depth_override=args.vit_depth,
            remat=args.remat, n_devices=args.n_devices, model_parallel=args.model_parallel)
        meta_dir = metadata_folder(results, args.network, tasks, name,
                                   args.plans_identifier, transfer, **arch)

        def folder(task, fold=fold):
            """The output folder of the sequence up to ``task``."""
            return build_output_folder(results, args.network, tasks,
                                       tasks[: tasks.index(task) + 1], name,
                                       args.plans_identifier, fold, transfer, **arch)

        trainer, finished, resume_task, resume_epoch = None, [], None, 0
        if args.continue_training:
            trainer, finished, resume_task, resume_epoch = _resume(
                tasks, opts, meta_dir, extension, fold, folder)
        if trainer is None:
            trainer = trainer_cls(first_plans, args.network,
                                  os.path.join(meta_dir, f"fold_{fold}_bootstrap"),
                                  opts, **hyper)
            if args.init_seq and args.initialize_with_network_trainer:
                # the first task starts from a trained model: its body, heads
                # and geometry
                init_tr = restore_trainer(args.initialize_with_network_trainer, opts)
                trainer.mh = init_tr.mh.add_n_tasks_and_activate(
                    init_tr.mh.tasks, init_tr.mh.tasks[-1])
                trainer.model, trainer.plan = init_tr.model, init_tr.plan
                trainer.patch_size = init_tr.patch_size
                print(f"[fold {fold}] initialized from "
                      f"{args.initialize_with_network_trainer} (tasks {init_tr.mh.tasks})")
        trainer.metadata_folder = meta_dir

        for task in tasks:
            if task in finished:
                continue
            trainer.set_output_folder(folder(task))
            trainer.train_task(task, stage_dir_for(pre, task, args.network),
                               start_epoch=resume_epoch if task == resume_task else 0)
            if trainer.is_main:
                print(f"[fold {fold}] finished {task} -> {folder(task)}")

        if args.disable_saving and trainer.is_main:
            for task in tasks[:-1]:
                shutil.rmtree(folder(task), ignore_errors=True)
    return 0


def _make_main(ext):
    def main():
        return run_training(ext)
    main.__name__ = f"main_{ext}"
    return main


# console-script entry points: nnUNet_torch_train_<extension> (setup.py
# also names main_frozen_body_seq nnUNet_torch_train_body_froz, as the JAX
# package does)
for _ext in TRAINER_MAP:
    globals()[f"main_{_ext}"] = _make_main(_ext)


if __name__ == "__main__":
    ext = sys.argv.pop(1) if len(sys.argv) > 1 and sys.argv[1] in TRAINER_MAP else "base_v2"
    raise SystemExit(run_training(ext))
