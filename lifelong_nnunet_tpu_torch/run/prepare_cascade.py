"""CLI: prepare the cascade's fullres stage with the PyTorch port —
``nnUNet_torch_prepare_cascade``.

The arguments of the JAX package's ``nnUNet_prepare_cascade``
(``lifelong_nnunet_tpu/run/prepare_cascade.py``), plus ``--device``
(default ``cuda``, never falling back to the CPU): serve a trained
3d_lowres checkpoint (``-ckpt``, the path without extension) over the
task's preprocessed lowres cases and write its fullres cases with the
upsampled one-hot predictions appended (``inference/cascade.py``) into
``$nnUNet_preprocessed/<task>/<data identifier>_cascade_fullres``, where
``CascadeFullResTrainer(...).train_task(task, stage)`` trains on them.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..device import resolve_device
from ..inference.cascade import prepare_cascade_stage
from .plan_and_preprocess import resolve_task
from .run_training import stage_dir_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_id", required=True)
    p.add_argument("-ckpt", required=True,
                   help="checkpoint base of the trained 3d_lowres model "
                        "(path without extension)")
    p.add_argument("-lowres_config", default="3d_lowres")
    p.add_argument("-fullres_config", default="3d_fullres")
    p.add_argument("--tta", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:N' or 'cpu')")
    return p


def cascade_stage_dir(pre_root: str, task: str) -> str:
    return os.path.join(pre_root, task, f"{paths.default_data_identifier}_cascade_fullres")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    task = os.path.basename(resolve_task(args.task_id, pre))
    low = stage_dir_for(pre, task, args.lowres_config)
    full = stage_dir_for(pre, task, args.fullres_config)
    out = cascade_stage_dir(pre, task)
    written = prepare_cascade_stage(args.ckpt, low, full, out, do_tta=args.tta,
                                    device=device)
    print(f"prepared {len(written)} cascade cases -> {out} on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
