"""The connected-component postprocessing decision, the port of
``lifelong_nnunet_tpu/inference/postprocessing.py``.

:func:`determine_postprocessing` segments a task's validation cases with a
trainer's model and the task's head (sliding window, no mirroring, window
batch 8, the input rounded to bf16 as the JAX harness feeds it), sums each
foreground class's tp / fp / fn over the cases with and without
``remove_all_but_largest_component``, and keeps the classes whose Dice the
filter raises by more than ``min_gain``; the decision goes to
``postprocessing.json`` beside the checkpoints, which
:func:`load_postprocessing` reads for ``nnUNet_torch_inference
--postprocess`` (every class where there is no decision, none where it
keeps none).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..evaluation.metrics import confusion_counts, dice_from_counts
from .predict import remove_all_but_largest_component
from .sliding_window import predict_sliding_window


def determine_postprocessing(trainer, task: str, output_folder: str | None = None,
                             min_gain: float = 0.0) -> dict:
    """Returns {"for_which_classes": [c, ...], "dice_raw": {c: dice},
    "dice_pp": {c: dice}} and writes it to ``postprocessing.json`` in
    ``output_folder`` (default the trainer's).  The trained parameters are
    back in the model afterwards."""
    ds, _tr, val = trainer._datasets[task]
    head = task if task in trainer.mh.tasks else trainer.mh.tasks[-1]
    nc = trainer.num_classes
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(trainer.mh.assemble(head))
    trainer.model.eval()
    counts = {"raw": np.zeros((nc - 1, 3), np.int64), "pp": np.zeros((nc - 1, 3), np.int64)}
    try:
        for case in val:
            arr = np.asarray(ds.load(case))
            data = torch.from_numpy(np.moveaxis(arr[:-1], 0, -1).astype(np.float32))
            seg = arr[-1].astype(np.int32)
            pred = predict_sliding_window(
                trainer.model, data.to(torch.bfloat16).float().numpy(), trainer.patch_size,
                nc, device=trainer.device, mirror_axes=(), window_batch=8,
                output="seg").astype(np.int32)
            for kind, p in (("raw", pred), ("pp", remove_all_but_largest_component(pred))):
                counts[kind] += np.stack(confusion_counts(p, seg, nc), axis=1)
    finally:
        trainer.model.load_state_dict(trained)
    dice = {kind: dice_from_counts(c[:, 0], c[:, 1], c[:, 2]) for kind, c in counts.items()}
    keep = [c + 1 for c in range(nc - 1)
            if np.nan_to_num(dice["pp"][c]) > np.nan_to_num(dice["raw"][c]) + min_gain]
    decision = {"for_which_classes": keep,
                "dice_raw": {c + 1: float(dice["raw"][c]) for c in range(nc - 1)},
                "dice_pp": {c + 1: float(dice["pp"][c]) for c in range(nc - 1)}}
    out_dir = output_folder or trainer.output_folder
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "postprocessing.json"), "w") as f:
        json.dump(decision, f, indent=2)
    return decision


def load_postprocessing(folder: str) -> list | None:
    """The classes to filter from ``folder``'s ``postprocessing.json`` (an
    empty list where the decision keeps none), or None when there is no
    decision file.  The JAX package's returns None for an empty decision
    too, and its ``--postprocess`` then filters every class."""
    p = os.path.join(folder, "postprocessing.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return list(json.load(f).get("for_which_classes") or [])
