"""CLI: training with the PyTorch port — ``nnUNet_torch_train_<extension>``
for ``multihead``, ``sequential`` and ``base_v2``.

The arguments of the JAX package's ``nnUNet_train_<method>``
(``lifelong_nnunet_tpu/run/run_training.py``), with ``--device`` (default
``cuda``, never falling back to the CPU) in place of its ``-d`` list.  One
task per run: the fold loop, the per-task output folder and metadata tree,
and the trainer's epoch loop are the JAX package's.  Options whose parts
are not ported yet (continuation ``-c``, ``--init_seq``, task-specific
LayerNorms, SPMD, progress validation, rematerialization, task sequences)
are refused, as ``nnUNet_torch_inference`` refuses its unported options.
``--use_vit`` trains the ViT-U-Net (``-v``, ``-v_type``, ``--do_LSA``,
``--do_SPT``, ``-vit_depth``) into the ``Generic_ViT_UNetV{v}/...`` folder
of the JAX CLI.  ``--no_pallas_conv`` trains on the plain route (no
hand-written kernels).

The trained model is served by ``nnUNet_torch_inference <network>
<extension> -trained_on <task>``.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..planning.plans import Plans, plans_path
from ..training.output_paths import build_output_folder, metadata_folder
from ..training.trainer import TrainerOptions
from ..training.trainers import TRAINER_MAP, get_trainer
from .plan_and_preprocess import resolve_task

# options kept for argument parity with the JAX CLI, with the value that
# means "off"; any other value is refused
UNPORTED_OPTIONS = {"continue_training": False, "init_seq": False,
                    "initialize_with_network_trainer": None,
                    "val_mode": "sliding_window", "use_progress_val": False,
                    "task_specific_ln": False, "n_devices": None, "model_parallel": 1,
                    "remat": False}


def build_parser(extension: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"Training with the PyTorch port: {extension}")
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("-f", "--folds", nargs="+", type=int, default=[0])
    p.add_argument("-s", "--split_at", default="seg_outputs")
    p.add_argument("-num_epochs", type=int, default=100)
    p.add_argument("-save_interval", type=int, default=25)
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("-c", "--continue_training", action="store_true")
    p.add_argument("--init_seq", action="store_true")
    p.add_argument("-initialize_with_network_trainer", default=None)
    p.add_argument("--no_transfer_heads", action="store_true")
    # deletes the folders of a sequence's earlier tasks: with one task there
    # are none, as in the JAX CLI
    p.add_argument("--disable_saving", action="store_true")
    p.add_argument("-val_mode", choices=["sliding_window", "patches"],
                   default="sliding_window")
    p.add_argument("--use_progress_val", action="store_true")
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
    p.add_argument("-n_devices", type=int, default=None)
    p.add_argument("-model_parallel", type=int, default=1)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no_pallas_conv", dest="use_kernels", action="store_false",
                   help="train on the plain route, without the hand-written kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda', 'cuda:N' or 'cpu')")
    return p


def stage_dir_for(pre_root: str, task_name: str, config: str,
                  data_identifier: str = paths.default_data_identifier) -> str:
    d = os.path.join(pre_root, task_name, f"{data_identifier}_{config}")
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"{d} missing — run nnUNet_plan_and_preprocess -t {task_name} first")
    return d


def _refuse_unported(args) -> None:
    set_ = [k for k, off in UNPORTED_OPTIONS.items() if getattr(args, k) != off]
    if len(args.task_ids) > 1:
        set_.append("a sequence of tasks")
    if set_:
        raise NotImplementedError(f"{', '.join(set_)}: not ported yet (the port "
                                  "trains one task on one device)")


def trainer_name(extension: str) -> str:
    """The JAX CLI's ``nnUNetTrainer<Ext>`` folder name."""
    special = {"multihead": "MultiHead", "sequential": "Sequential"}
    return f"nnUNetTrainer{special.get(extension, extension.capitalize())}"


def arch_kwargs(args) -> dict:
    """The ``arch_dir`` options of parsed CLI arguments."""
    return dict(vit=args.use_vit, vit_version=f"V{args.vit_version}",
                vit_type=args.vit_type, task_specific_ln=args.task_specific_ln,
                spt=args.do_SPT, lsa=args.do_LSA)


def output_folder(results: str, network: str, task: str, extension: str,
                  plans_identifier: str, fold: int, transfer_heads: bool,
                  **arch) -> str:
    return build_output_folder(results, network, [task], [task], trainer_name(extension),
                               plans_identifier, fold, transfer_heads, **arch)


def run_training(extension: str, argv=None) -> int:
    args = build_parser(extension).parse_args(argv)
    _refuse_unported(args)
    trainer_cls = get_trainer(extension)
    raw = paths.raw_data_dir(create=False)
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    results = paths.require(paths.results_dir(), "results")
    try:
        task = os.path.basename(resolve_task(args.task_ids[0], pre))
    except FileNotFoundError:
        task = os.path.basename(resolve_task(args.task_ids[0], raw or pre))
    plans = Plans.load(plans_path(os.path.join(pre, task), args.plans_identifier))
    transfer = trainer_cls.TRANSFER_HEADS and not args.no_transfer_heads
    name = trainer_name(extension)
    for fold in args.folds:
        opts = TrainerOptions(
            num_epochs=args.num_epochs, iters_per_epoch=args.num_iters,
            val_iters=args.val_iters, save_every=args.save_interval,
            split_at=args.split_at, fold=fold,
            dtype="float32" if args.fp32 else "bfloat16",
            patch_size=tuple(args.patch_size) if args.patch_size else None,
            batch_size=args.batch_size, augment=not args.no_augment,
            base_num_features=args.base_features, max_num_features=args.max_features,
            device=args.device, use_kernels=args.use_kernels, use_vit=args.use_vit,
            vit_version=f"V{args.vit_version}", vit_type=args.vit_type,
            vit_lsa=args.do_LSA, vit_spt=args.do_SPT, vit_depth_override=args.vit_depth)
        meta_dir = metadata_folder(results, args.network, [task], name,
                                   args.plans_identifier, transfer, **arch_kwargs(args))
        out_dir = output_folder(results, args.network, task, extension,
                                args.plans_identifier, fold, transfer, **arch_kwargs(args))
        trainer = trainer_cls(plans, args.network, out_dir, opts)
        trainer.metadata_folder = meta_dir
        trainer.train_task(task, stage_dir_for(pre, task, args.network))
        print(f"[fold {fold}] finished {task} -> {out_dir}")
    return 0


def _make_main(ext):
    def main():
        return run_training(ext)
    main.__name__ = f"main_{ext}"
    return main


# console-script entry points: nnUNet_torch_train_<extension>
for _ext in TRAINER_MAP:
    globals()[f"main_{_ext}"] = _make_main(_ext)


if __name__ == "__main__":
    import sys
    ext = sys.argv.pop(1) if len(sys.argv) > 1 and sys.argv[1] in TRAINER_MAP else "base_v2"
    raise SystemExit(run_training(ext))
