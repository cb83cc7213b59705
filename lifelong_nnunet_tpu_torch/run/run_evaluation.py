"""CLI: cross-task evaluation with the PyTorch port —
``nnUNet_torch_evaluate`` / ``nnUNet_torch_evaluate2``.

The arguments of the JAX package's ``nnUNet_evaluate`` /
``nnUNet_evaluate2`` (``lifelong_nnunet_tpu/run/run_evaluation.py``), plus
``--device`` (default ``cuda``, never falling back to the CPU).  The model
is located as ``nnUNet_torch_inference`` locates it
(``run/run_inference.py:_locate_model``: the base-trainer layout or the
sequence's folder, the JAX CLI's folder names), from the trainer, the
``-trained_on`` sequence, the ``-use_model`` prefix, the fold and the
architecture flags (``--task_specific_ln`` names the ``task_specific``
folder).

``nnUNet_torch_evaluate`` scores the validation split of each
``-evaluate_on`` task with :class:`~..evaluation.evaluator.Evaluator` into
``$EVALUATION_FOLDER/<the model folder relative to the results root>``;
``nnUNet_torch_evaluate2`` runs the whole inference pipeline on each task's
raw ``imagesTr`` (``evaluation/evaluator2.py``; ``-chk`` picks the
checkpoint, ``--evaluate_initialization`` the task's ``before_training``)
into its ``eval2`` subfolder.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..device import resolve_device
from ..evaluation.evaluator import Evaluator
from ..evaluation.evaluator2 import run_evaluation2
from ..training.checkpoints import CKPT_SUFFIX
from ..training.trainer import TrainerOptions
from .plan_and_preprocess import resolve_task
from .run_inference import _locate_model, _refuse_unported, _resolve_task
from .run_training import stage_dir_for


def build_parser(two: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("trainer", help="extension name or nnUNetTrainer* class name")
    p.add_argument("-trained_on", nargs="+", required=True,
                   help="task sequence the model was trained on (order matters)")
    p.add_argument("-use_model", "--use", nargs="+", default=None,
                   help="prefix of trained_on naming the task-stage model to load")
    p.add_argument("-evaluate_on", nargs="+", required=True, help="tasks to evaluate on")
    p.add_argument("-f", "--folds", nargs="+", type=int, default=[0])
    p.add_argument("-use_head", default=None)
    p.add_argument("--always_use_last_head", action="store_true")
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("--no_transfer_heads", action="store_true")
    p.add_argument("--use_vit", action="store_true")
    p.add_argument("-v", "--vit_version", type=int, default=1)
    p.add_argument("-v_type", "--vit_type", default="base")
    p.add_argument("--task_specific_ln", action="store_true")
    p.add_argument("--do_LSA", action="store_true")
    p.add_argument("--do_SPT", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:N' or 'cpu')")
    if two:
        p.add_argument("-chk", default="model_final_checkpoint")
        p.add_argument("--no_delete", action="store_true")
        p.add_argument("--disable_tta", action="store_true")
        p.add_argument("--evaluate_initialization", action="store_true",
                       help="evaluate the task's 'before_training' checkpoint")
        p.add_argument("--legacy_structure", action="store_true",
                       help="one merged val_metrics_*.{json,csv} and summarized txt "
                            "instead of per-task subfolders")
    return p


def _parse(two: bool, argv):
    args = build_parser(two).parse_args(argv)
    _refuse_unported(args)
    args.trained_on = [_resolve_task(t) for t in args.trained_on]
    if args.use:
        args.use = [_resolve_task(t) for t in args.use]
    return args


def run_evaluation(argv=None) -> int:
    args = _parse(False, argv)
    results = paths.require(paths.results_dir(create=False), "results")
    eval_root = paths.require(paths.evaluation_dir(), "evaluation")
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    for fold in args.folds:
        ckpt = _locate_model(args, results, fold)
        ev = Evaluator(ckpt, TrainerOptions(device=args.device))
        stages = {}
        for t in args.evaluate_on:
            name = os.path.basename(resolve_task(t, pre))
            stages[name] = stage_dir_for(pre, name, args.network)
        out = os.path.join(eval_root, os.path.relpath(os.path.dirname(ckpt), results))
        ev.evaluate_on(stages, out, use_head=args.use_head,
                       always_use_last_head=args.always_use_last_head)
        print(f"[fold {fold}] evaluation written to {out}")
    return 0


def run_evaluation2_cli(argv=None) -> int:
    args = _parse(True, argv)
    device = resolve_device(args.device)
    results = paths.require(paths.results_dir(create=False), "results")
    eval_root = paths.require(paths.evaluation_dir(), "evaluation")
    raw = paths.require(paths.raw_data_dir(create=False), "raw data")
    for fold in args.folds:
        ckpt = _locate_model(args, results, fold)
        chk = "before_training" if args.evaluate_initialization else args.chk
        base = os.path.join(os.path.dirname(ckpt), chk)
        if not os.path.isfile(base + CKPT_SUFFIX):
            base = ckpt
        raw_dirs = {os.path.basename(resolve_task(t, raw)): resolve_task(t, raw)
                    for t in args.evaluate_on}
        out = os.path.join(eval_root, os.path.relpath(os.path.dirname(ckpt), results),
                           "eval2")
        run_evaluation2(base, raw_dirs, out, device=device, use_head=args.use_head,
                        do_tta=not args.disable_tta, no_delete=args.no_delete, fold=fold,
                        legacy_structure=args.legacy_structure)
        print(f"[fold {fold}] evaluation2 written to {out}")
    return 0


def main():
    return run_evaluation()


def main2():
    return run_evaluation2_cli()


if __name__ == "__main__":
    raise SystemExit(main())
