"""Output-tree layout: path-encoded run configuration, reference-compatible.

The reference encodes configuration into the results tree
(``multihead/nnUNetTrainerMultiHead.py:1315-1361``)::

    RESULTS_FOLDER/nnUNet_ext/<network>/<joined_all_tasks>/<joined_running>/
      <Trainer>__<plans>/<Generic_UNet | Generic_ViT_UNetV{v}/<type>/
      (not_)task_specific/<SPT_LSA|...>>/<MH|SEQ>/fold_X

with a sibling ``metadata/`` tree holding the ``<ext>_trained_on`` state.  We
keep the same scheme for CLI compatibility plus an explicit ``run.json``
manifest inside each fold dir (the rebuild's "filesystem-as-database"
replacement, SURVEY.md §5).
"""

from __future__ import annotations

import os


def join_tasks(tasks) -> str:
    """Reference joins task names with '_' (helpful_functions.join_texts_with_char)."""
    return "_".join(tasks)


def arch_dir(vit: bool = False, vit_version: str = "V1", vit_type: str = "base",
             task_specific_ln: bool = False, spt: bool = False, lsa: bool = False) -> str:
    if not vit:
        return "Generic_UNet"
    variant = []
    if spt:
        variant.append("SPT")
    if lsa:
        variant.append("LSA")
    variant = "_".join(variant) if variant else "traditional"
    ts = "task_specific" if task_specific_ln else "not_task_specific"
    return os.path.join(f"Generic_ViT_UNet{vit_version}", vit_type.lower(), ts, variant)


def build_output_folder(results_root: str, network: str, all_tasks, running_tasks,
                        trainer_name: str, plans_identifier: str, fold: int,
                        transfer_heads: bool = False, **arch_kwargs) -> str:
    head_mode = "SEQ" if transfer_heads else "MH"
    return os.path.join(
        results_root, network, join_tasks(all_tasks), join_tasks(running_tasks),
        f"{trainer_name}__{plans_identifier}", arch_dir(**arch_kwargs),
        head_mode, f"fold_{fold}")


def metadata_folder(results_root: str, network: str, all_tasks,
                    trainer_name: str, plans_identifier: str,
                    transfer_heads: bool = False, **arch_kwargs) -> str:
    head_mode = "SEQ" if transfer_heads else "MH"
    return os.path.join(
        results_root, network, join_tasks(all_tasks), "metadata",
        f"{trainer_name}__{plans_identifier}", arch_dir(**arch_kwargs), head_mode)
