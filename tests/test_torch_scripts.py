"""The port's scripts (``lifelong_nnunet_tpu_torch/scripts/``) and helpers
(``utilities/helpful_functions.py``) against the JAX package's on the same
files: each runs on its own copy of the same inputs, and the trees they
leave must be equal (the same files; JSON equal as data; NIfTI images equal
in data, spacing and affine; other files byte for byte), as must every
returned value.  The cases are those of ``tests/test_scripts.py`` and
``tests/test_utilities.py``, plus ``delete_task`` and the label-joining
and channel-selecting conversions."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.scripts import create_split as j_split
from lifelong_nnunet_tpu.scripts import dataset_label_mapping as j_map
from lifelong_nnunet_tpu.scripts import delete_tasks as j_delete
from lifelong_nnunet_tpu.scripts import join_datasets as j_join
from lifelong_nnunet_tpu.scripts import update_checkpoints as j_update
from lifelong_nnunet_tpu.utilities import helpful_functions as j_hf
from lifelong_nnunet_tpu_torch.scripts import create_split as p_split
from lifelong_nnunet_tpu_torch.scripts import dataset_label_mapping as p_map
from lifelong_nnunet_tpu_torch.scripts import delete_tasks as p_delete
from lifelong_nnunet_tpu_torch.scripts import join_datasets as p_join
from lifelong_nnunet_tpu_torch.scripts import update_checkpoints as p_update
from lifelong_nnunet_tpu_torch.utilities import helpful_functions as p_hf
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image
from lifelong_nnunet_tpu_torch.utilities.nifti import NiftiImage, write


def _tree(root) -> dict:
    """{relative path: comparable content} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".json") and f != "broken.json":
                out[rel] = json.loads(open(p).read())
            elif f.endswith((".nii", ".nii.gz")):
                img = read_image(p)
                out[rel] = (np.asarray(img.data).dtype.str, np.asarray(img.data).tolist(),
                            tuple(np.round(img.spacing, 6)), np.asarray(img.affine).tolist())
            else:
                out[rel] = open(p, "rb").read()
    return out


def _both(make, tmp_path):
    """Two copies of the inputs ``make(root)`` writes: (JAX's root, the
    port's root)."""
    roots = tmp_path / "jax", tmp_path / "port"
    for r in roots:
        r.mkdir()
        make(r)
    return roots


def _src_task(root):
    src = root / "Task001_Src"
    (src / "imagesTr").mkdir(parents=True)
    (src / "labelsTr").mkdir()
    rng = np.random.RandomState(0)
    for case in ("case_a", "case_b"):
        write(str(src / "imagesTr" / f"{case}.nii.gz"),
              NiftiImage(rng.rand(8, 8, 8, 2).astype(np.float32), (1.5, 1.0, 2.0)))
        write(str(src / "labelsTr" / f"{case}.nii.gz"),
              NiftiImage(rng.randint(0, 3, (8, 8, 8)).astype(np.uint8), (1.5, 1.0, 2.0)))
    with open(src / "dataset.json", "w") as f:
        json.dump({"modality": {"0": "MRI", "1": "CT"},
                   "labels": {"0": "bg", "1": "a", "2": "b"}}, f)
    with open(root / "map.json", "w") as f:
        json.dump({"left hippocampus --> 1": 1, "right hippocampus --> 2": 1}, f)


CONVERSIONS = {"mapping": dict(mapping={1: 2, 2: 1}), "channel": dict(channel=1),
               "joined": dict(joined_labels=[1, 2]),
               "new_labels": dict(mapping={1: 1}, new_labels_json={"0": "bg", "1": "x"})}


@pytest.mark.parametrize("case", list(CONVERSIONS))
def test_dataset_label_mapping_matches_jax(tmp_path, case):
    """``convert_task`` (4-D split, channel selection, relabelling or label
    joining, dataset.json) gives JAX's tree; the small functions give JAX's
    values."""
    jroot, proot = _both(_src_task, tmp_path)
    for mod, root in ((j_map, jroot), (p_map, proot)):
        mod.convert_task(str(root / "Task001_Src"), str(root / "Task002_Dst"),
                         **CONVERSIONS[case])
    assert _tree(jroot) == _tree(proot)
    assert p_map.parse_mapping_file(str(proot / "map.json")) == \
        j_map.parse_mapping_file(str(jroot / "map.json")) == {1: 1, 2: 1}
    seg = np.random.RandomState(1).randint(0, 4, (5, 6)).astype(np.int16)
    np.testing.assert_array_equal(p_map.apply_label_mapping(seg, {1: 2, 2: 1}),
                                  j_map.apply_label_mapping(seg, {1: 2, 2: 1}))
    x = np.random.RandomState(2).rand(4, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(p_map.select_channel(x, 1), j_map.select_channel(x, 1))


def _two_tasks(root):
    for name in ("Task003_A", "Task004_B"):
        d = root / name
        (d / "imagesTr").mkdir(parents=True)
        (d / "labelsTr").mkdir()
        rng = np.random.RandomState(len(name))
        write(str(d / "imagesTr" / "x_0000.nii.gz"),
              NiftiImage(rng.rand(4, 4, 4).astype(np.float32)))
        write(str(d / "labelsTr" / "x.nii.gz"),
              NiftiImage(rng.randint(0, 2, (4, 4, 4)).astype(np.uint8)))
        with open(d / "dataset.json", "w") as f:
            json.dump({"modality": {"0": "MRI"}, "labels": {"0": "bg", "1": "fg"}}, f)


def test_join_datasets_matches_jax(tmp_path):
    jroot, proot = _both(_two_tasks, tmp_path)
    n = [mod.join_tasks([str(r / "Task003_A"), str(r / "Task004_B")], str(r / "Task005_J"))
         for mod, r in ((j_join, jroot), (p_join, proot))]
    assert n[0] == n[1] == 4
    assert _tree(jroot) == _tree(proot)


def test_create_split_matches_jax(synthetic_task, tmp_path):
    jroot, proot = _both(lambda r: shutil.copytree(synthetic_task, r / "Task097_SynthA"),
                         tmp_path)
    moved = [mod.create_split(str(r / "Task097_SynthA"), test_fraction=0.34)
             for mod, r in ((j_split, jroot), (p_split, proot))]
    assert moved[0] == moved[1] and len(moved[1]) == 2
    assert sorted(_tree(jroot)) == sorted(_tree(proot))


def _results(root):
    fold = root / "3d_fullres" / "T" / "fold_0"
    fold.mkdir(parents=True)
    with open(fold / "model_final_checkpoint.json", "w") as f:
        json.dump({"path": "/old/root/x", "nested": ["/old/root/y", 3], "n": 1}, f)
    with open(fold / "other.json", "w") as f:
        json.dump({"untouched": "/elsewhere"}, f)
    (fold / "model_final_checkpoint.pt").write_bytes(b"\x00/old/root\x01")
    (fold / "broken.json").write_text("{not json")


def test_update_checkpoints_matches_jax(tmp_path):
    """Only the JSON that holds the old prefix is rewritten (the ``.pt``
    files, which hold no path, and unreadable JSON are left alone)."""
    jroot, proot = _both(_results, tmp_path)
    n = [mod.update_tree(str(r), "/old/root", "/new/base", verbose=False)
         for mod, r in ((j_update, jroot), (p_update, proot))]
    assert n[0] == n[1] == 1
    assert _tree(jroot) == _tree(proot)


def test_delete_task_matches_jax(tmp_path, monkeypatch):
    """``delete_task`` removes the task from the raw and preprocessed trees,
    and from the results with ``include_results``."""
    def make(root):
        for sub in ("raw/nnUNet_raw_data", "pre", "results/nnUNet_ext"):
            for task in ("Task001_A", "Task002_B"):
                (root / sub / task).mkdir(parents=True)
                (root / sub / task / "f.txt").write_text(task)
    jroot, proot = _both(make, tmp_path)
    removed = {}
    for mod, r in ((j_delete, jroot), (p_delete, proot)):
        monkeypatch.setenv("nnUNet_raw_data_base", str(r / "raw"))
        monkeypatch.setenv("nnUNet_preprocessed", str(r / "pre"))
        monkeypatch.setenv("RESULTS_FOLDER", str(r / "results"))
        removed[mod] = [os.path.relpath(p, r) for p in mod.delete_task("Task001_A")] + \
            [os.path.relpath(p, r) for p in mod.delete_task("Task002_B", include_results=True)]
    assert removed[j_delete] == removed[p_delete] and len(removed[p_delete]) == 5
    assert _tree(jroot) == _tree(proot)


def test_helpers_match_jax(tmp_path, capsys):
    """Strings, divisors, the nested-dict flattening and its pandas frame
    and CSV (pandas imported inside the function), stdout suppression,
    directory operations and the re-exported logger."""
    assert p_hf.join_texts_with_char(["a", 1, "c"], "-") == \
        j_hf.join_texts_with_char(["a", 1, "c"], "-") == "a-1-c"
    for a, b in ((40, 56), (7, 5), (64, 48)):
        assert p_hf.commDiv(a, b) == j_hf.commDiv(a, b)
    d = {"a": {"x": 1, "y": {"z": 2.5}}, "b": {"x": "s"}}
    assert p_hf.flatten_nested_dict(d) == j_hf.flatten_nested_dict(d)
    frames = [mod.nested_dict_to_dataframe(d) for mod in (j_hf, p_hf)]
    assert frames[0].equals(frames[1])
    csvs = [mod.dumpDataFrameToCsv(f, str(tmp_path / name), "t.csv")
            for mod, f, name in ((j_hf, frames[0], "j"), (p_hf, frames[1], "p"))]
    assert open(csvs[0], "rb").read() == open(csvs[1], "rb").read()
    with p_hf.suppress_stdout():
        print("hidden")
    print("visible")
    out = capsys.readouterr().out
    assert "hidden" not in out and "visible" in out
    for mod, name in ((j_hf, "j"), (p_hf, "p")):
        src = tmp_path / f"src_{name}"
        (src / "sub").mkdir(parents=True)
        (src / "sub" / "f.txt").write_text("x")
        mod.copy_dir(str(src), str(tmp_path / f"copy_{name}"))
        mod.move_dir(str(tmp_path / f"copy_{name}"), str(tmp_path / "moved" / name))
        mod.delete_dir_con(str(src))
        assert not src.exists()
    assert _tree(tmp_path / "moved" / "j") == _tree(tmp_path / "moved" / "p")
    log = p_hf.RunLogger(str(tmp_path / "log"), also_print=False)
    log("hello", 42)
    assert "hello 42" in open(log.path).read()


def test_parameter_counts_match_jax():
    """``get_nr_parameters`` / ``get_model_size`` of the port's U-Net (the
    module and its state_dict) equal JAX's of the same model's flax tree."""
    import jax
    import jax.numpy as jnp

    from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
    from lifelong_nnunet_tpu_torch.models.unet import GenericUNet
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=((2, 2, 2),),
                 conv_kernel_sizes=((3, 3, 3),) * 2, base_num_features=4, max_num_features=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))["params"]
    tm = GenericUNet(1, 3, ((2, 2, 2),), ((3, 3, 3),) * 2, 4, 8)
    n = j_hf.get_nr_parameters(params)
    assert p_hf.get_nr_parameters(tm) == p_hf.get_nr_parameters(tm.state_dict()) == n
    assert p_hf.get_model_size(tm, bits=16) == j_hf.get_model_size(params, bits=16)
    assert p_hf.get_nr_parameters({"w": torch.zeros(3, 4), "b": torch.zeros(5)}) == 17
