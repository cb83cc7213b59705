"""The port's input sharding and its C++ patch gather, held against the JAX
package on the CPU, in this process (no ranks are started):

* the sampler at the node shard: for the shards (0, 2) and (1, 2) of a
  global batch of 4, at local worlds 1 and 2, the rows the port's ranks
  draw (their ``rows``, in rank order) equal JAX ``PatchSampler(shard=(i,
  n))``'s batches bit for bit, over three batches, on the native and the
  numpy path;
* the native gather against the numpy crop, bit for bit, with origins
  outside the volume on every side (data 0, seg -1), and the same
  sampler's batches on both paths;
* a second build of the library in another process (``force``) while this
  one loads it: every copy of the file read meanwhile loads, and no
  temporary file is left."""

import ctypes
import multiprocessing as mp
import os

import numpy as np
import pytest

from lifelong_nnunet_tpu.data.dataset import PreprocessedDataset as JaxDataset
from lifelong_nnunet_tpu.data.sampler import PatchSampler as JaxSampler
from lifelong_nnunet_tpu_torch.data import native
from lifelong_nnunet_tpu_torch.data.dataset import PreprocessedDataset
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess

TASK = "Task097_SynthA"
PATCH = (16, 16, 16)
BATCH = 4


@pytest.fixture(scope="module")
def stage(synthetic_task, tmp_path_factory):
    pre = tmp_path_factory.mktemp("shard") / "pre"
    plan_and_preprocess([synthetic_task], str(pre), configs=("3d_fullres",), verbose=False)
    return str(pre / TASK / "nnUNetData_plans_v2.1_3d_fullres")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("local_world", [1, 2])
@pytest.mark.parametrize("shard", [(0, 2), (1, 2)])
def test_node_shard_rows_equal_the_jax_shard(stage, shard, local_world, use_native):
    jds, ds = JaxDataset(stage), PreprocessedDataset(stage)
    jax_s = JaxSampler(jds, jds.cases, PATCH, BATCH, seed=5, shard=shard)
    node = BATCH // shard[1]
    per = node // local_world
    ranks = [PatchSampler(ds, ds.cases, PATCH, BATCH, seed=5, shard=shard,
                          rows=(r * per, (r + 1) * per), native=use_native)
             for r in range(local_world)]
    assert all(s.batch_size == per and s.native == use_native for s in ranks)
    for _ in range(3):
        want = jax_s.next_batch()
        got = [s.next_batch() for s in ranks]
        data = np.concatenate([g["data"] for g in got])
        seg = np.concatenate([g["seg"] for g in got])
        assert data.dtype == np.float32 and seg.dtype == np.int8
        np.testing.assert_array_equal(data, np.moveaxis(want["data"], -1, 1))
        np.testing.assert_array_equal(seg, want["seg"])
        assert sum((g["keys"] for g in got), []) == want["keys"]


def test_native_gather_equals_the_numpy_crop():
    rng = np.random.RandomState(0)
    arrays = []
    for shape in ((9, 12, 10), (7, 7, 7), (11, 8, 13)):
        a = rng.randn(3, *shape).astype(np.float32)
        a[-1] = rng.randint(-1, 3, size=shape)
        arrays.append(a)
    patch = (6, 5, 7)
    sampler = PatchSampler(None, [(None, "x")], patch, 1, native=False)
    # origins of patches that overlap the volume (the sampler's domain: a
    # random origin in [min(0, s - p), s - p], a foreground centre inside),
    # out of it on either side of every axis, the extremes included
    jobs = []
    for a in arrays:
        lo = [1 - p for p in patch]
        hi = [s - 1 for s in a.shape[1:]]
        jobs += [(a, tuple(lo)), (a, tuple(hi)), (a, (0, 0, 0))]
        jobs += [(a, tuple(rng.randint(l, h + 1) for l, h in zip(lo, hi))) for _ in range(6)]
    for a, origin in jobs:
        data, seg = native.gather_patches([a], [origin], patch)
        want_d, want_s = sampler._crop(a, list(origin))
        np.testing.assert_array_equal(data[0], want_d)
        np.testing.assert_array_equal(seg[0], want_s.astype(np.int8))
    # a batch on threads, one origin a sample
    data, seg = native.gather_patches([a for a, _ in jobs], [o for _, o in jobs], patch,
                                      n_threads=3)
    for b, (a, o) in enumerate(jobs):
        want_d, want_s = sampler._crop(a, list(o))
        np.testing.assert_array_equal(data[b], want_d)
        np.testing.assert_array_equal(seg[b], want_s.astype(np.int8))
    with pytest.raises(ValueError, match="float32"):
        native.gather_patches([arrays[0].astype(np.float64)], [(0, 0, 0)], patch)


def test_sampler_batches_equal_on_both_paths(stage):
    ds = PreprocessedDataset(stage)
    a = PatchSampler(ds, ds.cases, (24, 20, 28), 3, seed=11)
    b = PatchSampler(ds, ds.cases, (24, 20, 28), 3, seed=11, native=False)
    assert a.native and not b.native
    for _ in range(4):
        x, y = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(x["data"], y["data"])
        np.testing.assert_array_equal(x["seg"], y["seg"])
        assert x["keys"] == y["keys"]


def _force_build(out_dir: str) -> None:
    from pathlib import Path

    from lifelong_nnunet_tpu_torch.data import native as n
    n.build_library(Path(out_dir), force=True)


def test_a_build_in_another_process_never_shows_a_partial_library(tmp_path):
    out = tmp_path / "lib"
    path = native.build_library(out)
    child = mp.get_context("spawn").Process(target=_force_build, args=(str(out),))
    child.start()
    loads = 0
    while child.is_alive() or loads < 3:
        copy = tmp_path / f"copy{loads}.so"
        copy.write_bytes(path.read_bytes())
        lib = ctypes.CDLL(str(copy))
        assert hasattr(lib, "gather_patches_cf")
        loads += 1
    child.join(timeout=120)
    assert not child.is_alive() and child.exitcode == 0
    assert sorted(os.listdir(out)) == [path.name]
