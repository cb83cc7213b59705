"""CLI: prediction on a folder of images with the PyTorch port —
``nnUNet_torch_inference``.

The arguments of the JAX package's ``nnUNet_inference``
(``lifelong_nnunet_tpu/run/run_inference.py``), plus ``--device``, which
defaults to ``cuda`` and never falls back to the CPU.  The model is looked
up as the JAX CLI's ``_locate_model`` (``run/run_evaluation.py:80-112``)
does:

* ``nnUNetTrainerV2`` (``Generic_UNet``) and ``nnViTUNetTrainer`` /
  ``vit_unet`` (``Generic_ViT_UNetV{v}/<type>/<not_task_specific |
  task_specific>/<variant>``, from ``-v``, ``-v_type``,
  ``--task_specific_ln``, ``--do_SPT``, ``--do_LSA``: the folder
  ``nnUNet_torch_train_vit`` writes) in the base-trainer layout
  ``$RESULTS_FOLDER/nnUNet_ext/<network>/<task>/<Trainer>__<plans>/<arch>/fold_X``;
* ``base_v2`` in the folder that ``nnUNet_torch_train_base_v2`` writes
  (``<network>/<task>/<task>/nnUNetTrainerBase_v2__<plans>/<arch>/SEQ/fold_X``;
  the JAX CLI reads ``base_v2`` from the base-trainer layout, where its
  trainer does not write);
* the continual-learning trainers of the port's registry
  (``training/trainers/__init__.py``, by extension or class name) in the
  sequence's folder ``<network>/<trained_on>/<use or trained_on>/
  <Trainer>__<plans>/<arch>/<MH|SEQ>/fold_X``, ``SEQ`` for a
  head-transferring trainer unless ``--no_transfer_heads``.

``nnUNet_torch_evaluate`` / ``nnUNet_torch_evaluate2`` locate models the
same way.  ``-use_head`` picks the head (default the last task's).  The
checkpoint's manifest says whether the network is a U-Net or a ViT-U-Net.
``--postprocess`` keeps the largest component of the classes that the
``postprocessing.json`` beside the checkpoint names
(``inference/postprocessing.py``), of every class where there is none.
A ViT-U-Net with task-specific LayerNorms serves every head with the
LayerNorm set of its manifest's ``active_task_idx`` (the last trained
task's), as the JAX CLI does.  Cases are served through the volume
stream (``inference/predict.py``, the JAX CLI's default); the ``2d``
configuration predicts each volume slice by slice.  An unknown trainer
raises.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..device import resolve_device
from ..inference.postprocessing import load_postprocessing
from ..inference.predict import predict_from_folder
from ..run.plan_and_preprocess import resolve_task
from ..run.run_training import arch_kwargs, output_folder, trainer_name
from ..training.output_paths import arch_dir, build_output_folder
from ..training.restore import find_checkpoint, restore_model
from ..training.trainers import get_trainer

# base trainer -> whether its layout holds a ViT-U-Net (the JAX CLI's rule)
BASE_TRAINERS = {"nnUNetTrainerV2": False, "base_v2": False,
                 "nnViTUNetTrainer": True, "vit_unet": True}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("trainer")
    p.add_argument("-i", "--input_folder", required=True)
    p.add_argument("-o", "--output_folder", required=True)
    p.add_argument("-trained_on", nargs="+", required=True)
    p.add_argument("-use_model", "--use", nargs="+", default=None)
    p.add_argument("-f", "--folds", nargs="+", type=int, default=[0],
                   help="folds to ensemble (softmax-averaged)")
    p.add_argument("-use_head", default=None)
    p.add_argument("-chk", default="model_final_checkpoint")
    p.add_argument("--disable_tta", action="store_true")
    p.add_argument("--postprocess", action="store_true",
                   help="largest-connected-component per class")
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("--no_transfer_heads", action="store_true")
    p.add_argument("--use_vit", action="store_true")
    p.add_argument("-v", "--vit_version", type=int, default=1)
    p.add_argument("-v_type", "--vit_type", default="base")
    p.add_argument("--task_specific_ln", action="store_true")
    p.add_argument("--do_LSA", action="store_true")
    p.add_argument("--do_SPT", action="store_true")
    p.add_argument("-window_batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:N' or 'cpu')")
    return p


def _resolve_task(task: str) -> str:
    """Numeric task ids resolve to TaskXXX_Name against the preprocessed
    root, then the raw root, as the JAX CLIs do."""
    for root in (paths.preprocessed_dir(create=False),
                 paths.raw_data_dir(create=False)):
        if root and os.path.isdir(root):
            try:
                return os.path.basename(resolve_task(task, root))
            except (FileNotFoundError, ValueError):
                continue
    return task


def _refuse_unported(args) -> None:
    if args.trainer not in BASE_TRAINERS:
        get_trainer(args.trainer)      # raises for an unknown trainer


def _locate_model(args, results: str, fold: int) -> str:
    task = (args.use or args.trained_on)[-1]
    if args.trainer not in BASE_TRAINERS:
        cls = get_trainer(args.trainer)
        name = args.trainer if args.trainer.startswith("nnUNetTrainer") \
            else trainer_name(args.trainer)
        folder = build_output_folder(
            results, args.network, args.trained_on, args.use or args.trained_on, name,
            args.plans_identifier, fold, cls.TRANSFER_HEADS and not args.no_transfer_heads,
            **arch_kwargs(args))
    elif args.trainer == "base_v2":
        folder = output_folder(results, args.network, task, "base_v2",
                               args.plans_identifier, fold, transfer_heads=True,
                               **arch_kwargs(args))
    else:
        is_vit = BASE_TRAINERS[args.trainer]
        name = "nnViTUNetTrainer" if is_vit else "nnUNetTrainerV2"
        folder = os.path.join(results, args.network, task,
                              f"{name}__{args.plans_identifier}",
                              arch_dir(vit=is_vit, vit_version=f"V{args.vit_version}",
                                       vit_type=args.vit_type,
                                       task_specific_ln=args.task_specific_ln,
                                       spt=args.do_SPT, lsa=args.do_LSA),
                              f"fold_{fold}")
    ckpt = find_checkpoint(folder)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint in {folder}")
    return ckpt


def run_inference(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    args.trained_on = [_resolve_task(t) for t in args.trained_on]
    if args.use:
        args.use = [_resolve_task(t) for t in args.use]
    results = paths.require(paths.results_dir(create=False), "results")
    models, plans, config_name, base = [], None, None, None
    for fold in args.folds:
        ckpt = _locate_model(args, results, fold)
        base = os.path.join(os.path.dirname(ckpt), args.chk)
        if not os.path.isfile(base + ".pt"):
            base = ckpt
        model, plans, config_name = restore_model(base, device, head=args.use_head)
        models.append(model)
    post = None
    if args.postprocess:
        post = load_postprocessing(os.path.dirname(base))
        post = plans.all_classes if post is None else post
    written = predict_from_folder(
        models, plans, config_name, args.input_folder, args.output_folder,
        device=device, do_tta=not args.disable_tta,
        window_batch=args.window_batch, postprocess_labels=post)
    print(f"wrote {len(written)} segmentations to {args.output_folder} "
          f"on {device} (head {args.use_head or 'of the last task'})")
    return 0


def main():
    return run_inference()


if __name__ == "__main__":
    raise SystemExit(main())
