"""The port's own host modules (planning, preprocessing, NIfTI and image
I/O, metrics, the synthetic-task maker: copies of the JAX package's
jax-free modules, which the port may not import) give what the JAX
package's give: the same plans JSON, the same preprocessed ``.npy`` /
props / class locations, the same NIfTI bytes, the same metrics, and the
same synthetic task as ``tests/synthetic.py``."""

import gzip
import json
import os

import numpy as np
import pytest

from lifelong_nnunet_tpu.evaluation import metrics as jm
from lifelong_nnunet_tpu.run.plan_and_preprocess import plan_and_preprocess as jax_plan
from lifelong_nnunet_tpu.utilities import imageio as jio, nifti as jnifti
from lifelong_nnunet_tpu_torch.evaluation import metrics as tm
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.utilities import imageio as tio, nifti as tnifti
from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task
from tests.synthetic import make_synthetic_task as jax_make_synthetic_task


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _payload(path):
    """A file's bytes; a gzip member's uncompressed bytes (its header holds
    the time of writing)."""
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if path.endswith(".gz") else data


@pytest.fixture(scope="module")
def both_tasks(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    kw = dict(task_name="Task096_Same", num_cases=3, seed=4, shape=(20, 26, 18))
    return (make_synthetic_task(str(root / "port"), **kw),
            jax_make_synthetic_task(str(root / "jax"), **kw))


def test_synthetic_task_maker_writes_what_tests_synthetic_writes(both_tasks):
    port, ref = both_tasks
    assert _files(port) == _files(ref)
    for rel in _files(ref):
        assert _payload(os.path.join(port, rel)) == _payload(os.path.join(ref, rel)), rel


def test_plans_and_preprocessed_data_match(both_tasks, tmp_path):
    port, _ = both_tasks
    out_p = plan_and_preprocess([port], str(tmp_path / "port"), configs=("3d_fullres", "2d"),
                                verbose=False)
    out_j = jax_plan([port], str(tmp_path / "jax"), configs=("3d_fullres", "2d"),
                     verbose=False)
    assert list(out_p) == list(out_j)
    task = os.path.basename(port)
    root_p, root_j = tmp_path / "port" / task, tmp_path / "jax" / task
    assert _files(root_p) == _files(root_j) and len(_files(root_j)) >= 19
    for rel in _files(root_j):
        a, b = str(root_p / rel), str(root_j / rel)
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=rel)
        elif rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in zb.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        else:
            assert _payload(a) == _payload(b), rel


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".nrrd", ".mha"])
def test_image_writers_give_the_same_bytes(tmp_path, suffix):
    rng = np.random.RandomState(0)
    img = tnifti.NiftiImage(rng.rand(5, 6, 7).astype(np.float32), spacing=(1.0, 0.5, 2.0))
    jimg = jnifti.NiftiImage(img.data, spacing=img.spacing)
    tio.write_image(str(tmp_path / f"port{suffix}"), img)
    jio.write_image(str(tmp_path / f"jax{suffix}"), jimg)
    assert _payload(str(tmp_path / f"port{suffix}")) == _payload(str(tmp_path / f"jax{suffix}"))
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / f"jax{suffix}")).data,
                                  img.data)


def test_subject_metrics_match():
    rng = np.random.RandomState(1)
    pred, target = rng.randint(0, 3, size=(2, 9, 8, 7))
    assert tm.subject_metrics(pred, target, 3) == jm.subject_metrics(pred, target, 3)
    acc = rng.rand(3, 3)
    assert tm.backward_transfer(acc) == jm.backward_transfer(acc)
    assert tm.forward_transfer(acc) == jm.forward_transfer(acc)
