"""CLI: single-task ViT-U-Net training with the PyTorch port —
``nnUNet_torch_train_vit``.

The port of ``lifelong_nnunet_tpu/run/run_training_vit.py``: nnU-Net-style
positional (network, task, fold) arguments, one task, the Generic_ViT_UNet
backbone (``-trainer_class nnViTUNetTrainer``, the default) or a plain
single-task U-Net (``nnUNetTrainerV2``), written to
``$RESULTS_FOLDER/nnUNet_ext/<network>/<task>/<trainer_class>__<plans>/
<Generic_ViT_UNetV{v}/<type>/<not_task_specific | task_specific>/<variant> |
Generic_UNet>/fold_X``, where ``nnUNet_torch_inference <network> <trainer_class> -trained_on <task>``
finds it.  Added to the JAX CLI's arguments: ``--device`` (default
``cuda``, never falling back to the CPU) and ``--no_pallas_conv`` (the
plain route, without the hand-written kernels), and ``--task_specific_ln``
(the ViT's LayerNorms per task, here the one task's set, in the
``task_specific`` folder).
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..planning.plans import Plans, plans_path
from ..training.output_paths import arch_dir
from ..training.trainer import TrainerOptions
from ..training.trainers.sequential import BaseUNetTrainer, ViTUNetTrainer
from .plan_and_preprocess import resolve_task
from .run_training import stage_dir_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("task")
    p.add_argument("fold", type=int)
    p.add_argument("-trainer_class", default="nnViTUNetTrainer",
                   choices=["nnViTUNetTrainer", "nnUNetTrainerV2"])
    p.add_argument("-num_epochs", type=int, default=100)
    p.add_argument("-num_iters", type=int, default=250)
    p.add_argument("-val_iters", type=int, default=50)
    p.add_argument("-save_interval", type=int, default=25)
    p.add_argument("-v", "--vit_version", type=int, default=1, choices=[1, 2, 3, 4])
    p.add_argument("-v_type", "--vit_type", default="base",
                   choices=["base", "large", "huge"])
    p.add_argument("--do_LSA", action="store_true")
    p.add_argument("--do_SPT", action="store_true")
    p.add_argument("--task_specific_ln", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("-patch_size", nargs="+", type=int, default=None)
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-base_features", type=int, default=None)
    p.add_argument("-max_features", type=int, default=None)
    p.add_argument("-vit_depth", type=int, default=None)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_pallas_conv", dest="use_kernels", action="store_false",
                   help="train on the plain route, without the hand-written kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda', 'cuda:N' or 'cpu')")
    return p


def run_training_vit(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    results = paths.require(paths.results_dir(), "results")
    task = os.path.basename(resolve_task(args.task, pre))
    plans = Plans.load(plans_path(os.path.join(pre, task), args.plans_identifier))
    use_vit = args.trainer_class == "nnViTUNetTrainer"
    version = f"V{args.vit_version}"
    opts = TrainerOptions(
        num_epochs=args.num_epochs, iters_per_epoch=args.num_iters,
        val_iters=args.val_iters, save_every=args.save_interval, fold=args.fold,
        dtype="float32" if args.fp32 else "bfloat16",
        patch_size=tuple(args.patch_size) if args.patch_size else None,
        batch_size=args.batch_size, augment=not args.no_augment,
        base_num_features=args.base_features, max_num_features=args.max_features,
        device=args.device, use_kernels=args.use_kernels, use_vit=use_vit,
        vit_version=version, vit_type=args.vit_type, vit_lsa=args.do_LSA,
        vit_spt=args.do_SPT, vit_task_specific_ln=args.task_specific_ln,
        vit_depth_override=args.vit_depth)
    out = os.path.join(
        results, args.network, task, f"{args.trainer_class}__{args.plans_identifier}",
        arch_dir(vit=use_vit, vit_version=version, vit_type=args.vit_type,
                 task_specific_ln=args.task_specific_ln, spt=args.do_SPT, lsa=args.do_LSA),
        f"fold_{args.fold}")
    trainer_cls = ViTUNetTrainer if use_vit else BaseUNetTrainer
    trainer = trainer_cls(plans, args.network, out, opts)
    trainer.train_task(task, stage_dir_for(pre, task, args.network))
    print(f"finished {task} -> {out}")
    return 0


def main():
    return run_training_vit()


if __name__ == "__main__":
    raise SystemExit(main())
