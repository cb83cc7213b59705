"""The port's data path (data/dataset.py, sampler.py, augment.py,
pipeline.py) against the JAX package's: the split without scikit-learn
equals ``KFold``'s, one seed gives the same patch batches, each moreDA
transform with the parameters the JAX package drew gives the same output as
``_augment_one``'s gather path, and the port's own draws fire at moreDA's
rates (distributional, as tests/test_augment_parity.py checks the JAX
draws)."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.data import augment as ja
from lifelong_nnunet_tpu.data.dataset import (final_splits as jax_final_splits,
                                              kfold_split as jax_kfold_split,
                                              param_search_split as jax_param_split)
from lifelong_nnunet_tpu.data.sampler import PatchSampler as JaxPatchSampler
from lifelong_nnunet_tpu_torch.data import augment as ta
from lifelong_nnunet_tpu_torch.data.dataset import (PreprocessedDataset, final_splits,
                                                    kfold_split, param_search_split)
from lifelong_nnunet_tpu_torch.data.pipeline import Prefetcher
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 11, 13])
def test_kfold_split_equals_sklearns(n):
    cases = [f"case_{i:03d}" for i in range(n)][::-1]
    for fold in (-1, 0, 1, 2, 3, 4, 7):
        assert kfold_split(cases, fold) == jax_kfold_split(cases, fold), (n, fold)


def test_final_splits_and_param_split(tmp_path):
    cases = [f"c{i}" for i in range(9)]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert final_splits(str(tmp_path / "port"), cases) == \
        jax_final_splits(str(tmp_path / "jax"), cases)
    assert json.loads((tmp_path / "port" / "splits_final.json").read_text()) == \
        json.loads((tmp_path / "jax" / "splits_final.json").read_text())
    assert param_search_split(cases) == jax_param_split(cases)


@pytest.fixture(scope="module")
def stage(synthetic_task, tmp_path_factory):
    out = plan_and_preprocess([synthetic_task], str(tmp_path_factory.mktemp("pre")),
                              configs=("3d_fullres",), verbose=False)
    return next(iter(out.values()))["3d_fullres"]


@pytest.mark.parametrize("patch,batch", [((16, 16, 16), 3), ((40, 24, 20), 2)])
def test_patch_sampler_gives_the_jax_samplers_batches(stage, patch, batch):
    """Same seed, same draws: identical data and seg (the port channels-
    first), foreground-forced samples and out-of-volume padding included."""
    ds = PreprocessedDataset(stage)
    port = PatchSampler(ds, ds.cases, patch, batch, seed=5)
    ref = JaxPatchSampler(ds, ds.cases, patch, batch, seed=5)
    ref._native = False                       # the numpy path the port keeps
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        assert a["keys"] == b["keys"]
        assert a["data"].shape == (batch, 1) + patch and a["seg"].dtype == np.int8
        np.testing.assert_array_equal(a["data"], np.moveaxis(b["data"], -1, 1))
        np.testing.assert_array_equal(a["seg"], b["seg"])


def test_prefetcher_gives_the_samplers_batches_on_the_device(stage):
    ds = PreprocessedDataset(stage)
    want = PatchSampler(ds, ds.cases, (16, 16, 16), 2, seed=1)
    pre = Prefetcher(PatchSampler(ds, ds.cases, (16, 16, 16), 2, seed=1),
                     torch.device("cpu"))
    try:
        for _ in range(3):
            batch, keys = pre.next()
            ref = want.next_batch()
            assert keys == ref["keys"]
            np.testing.assert_array_equal(batch["data"].numpy(), ref["data"])
            np.testing.assert_array_equal(batch["seg"].numpy(), ref["seg"])
    finally:
        pre.stop()


# ---- augmentation: the JAX draws, handed to the port's apply_params

def _jax_draws(key, cfg, shape):
    """The parameters ``_augment_one`` draws from ``key`` for one sample of
    channels-last ``shape``, in the port's layout (batch of 1)."""
    dim = len(shape) - 1
    keys = jax.random.split(key, 18)
    u = lambda k, lo=0.0, hi=1.0: float(jax.random.uniform(k, (), minval=lo, maxval=hi))
    k_rot, k_rotp, k_scale, k_scalep = jax.random.split(keys[0], 4)
    n_ang = 3 if dim == 3 else 1
    angles = np.asarray(jax.random.uniform(k_rot, (n_ang,), minval=-cfg.rot_max,
                                           maxval=cfg.rot_max))
    if not (cfg.do_rotation and u(k_rotp) < cfg.p_rot):
        angles = np.zeros(n_ang, np.float32)
    scale = u(k_scale, *cfg.scale_range)
    scale = scale if cfg.do_scaling and u(k_scalep) < cfg.p_scale else 1.0
    lowres = u(keys[1], 1.0, 2.0)
    p = {"angles": angles[None], "scale": [scale],
         "lowres": [lowres if u(keys[2]) < cfg.p_lowres else 1.0]}
    kg = keys[12:18]
    for name, kv, kd, prob, lo, hi in (
            ("noise", keys[3], keys[4], cfg.p_noise, 0.0, 0.1),
            ("blur", keys[6], keys[7], cfg.p_blur) + tuple(cfg.blur_sigma),
            ("brightness", keys[8], keys[9], cfg.p_brightness, 0.75, 1.25),
            ("contrast", keys[10], keys[11], cfg.p_contrast, 0.75, 1.25),
            ("gamma_inverted", kg[0], kg[1], cfg.p_gamma_inverted) + tuple(cfg.gamma_range),
            ("gamma", kg[2], kg[3], cfg.p_gamma) + tuple(cfg.gamma_range)):
        p[name], p[f"do_{name}"] = [u(kv, lo, hi)], [u(kd) < prob]
    km = jax.random.split(kg[4], dim)
    p["mirror"] = [[u(km[a]) < 0.5 for a in range(dim)]]
    if cfg.do_elastic:
        k_e, k_ep = jax.random.split(jax.random.fold_in(keys[0], 7))
        p["elastic"], p["do_elastic"] = [u(k_e, *cfg.elastic_magnitude)], [u(k_ep) < cfg.p_eldef]
        coarse = tuple(max(2, s // cfg.elastic_grid) for s in shape[:-1])
        p["elastic_field"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(k_e, 1), (dim,) + coarse, minval=-1.0, maxval=1.0))[None]
    params = {k: torch.tensor(np.asarray(v, np.float32) if not k.startswith("do_")
                              and k != "mirror" else v) for k, v in p.items()}
    noise = np.moveaxis(np.asarray(jax.random.normal(keys[5], shape)), -1, 0)[None]
    return params, torch.from_numpy(np.ascontiguousarray(noise))


ONE_AT_A_TIME = {
    "rotation": dict(do_rotation=True, p_rot=1.0),
    "scaling": dict(do_scaling=True, p_scale=1.0),
    "rotation+scaling+lowres": dict(do_rotation=True, p_rot=1.0, do_scaling=True,
                                    p_scale=1.0, p_lowres=1.0),
    "lowres": dict(p_lowres=1.0),
    "noise": dict(p_noise=1.0),
    "blur": dict(p_blur=1.0),
    "brightness": dict(p_brightness=1.0),
    "contrast": dict(p_contrast=1.0),
    "gamma_inverted": dict(p_gamma_inverted=1.0),
    "gamma": dict(p_gamma=1.0),
    "mirror": dict(do_mirror=True),
    "moreDA defaults": None,
    "elastic": dict(do_elastic=True, p_eldef=1.0),
    "elastic+rotation+scaling+lowres": dict(do_elastic=True, p_eldef=1.0, do_rotation=True,
                                            p_rot=1.0, do_scaling=True, p_scale=1.0,
                                            p_lowres=1.0),
    "elastic 2d": dict(do_elastic=True, p_eldef=1.0),
    "elastic+rotation+scaling+lowres 2d": dict(do_elastic=True, p_eldef=1.0,
                                               do_rotation=True, p_rot=1.0,
                                               do_scaling=True, p_scale=1.0, p_lowres=1.0),
    "moreDA defaults+elastic": dict(do_elastic=True),
}
# channels-last sample shapes; the others (12, 14, 10, 2)
SHAPES = {"elastic 2d": (20, 14, 2), "elastic+rotation+scaling+lowres 2d": (20, 14, 2)}


@pytest.mark.parametrize("name", list(ONE_AT_A_TIME))
def test_transform_matches_augment_one_gather_path(name):
    """Data within 1e-4, seg equal, on all but 0.1% of voxels: a rotated
    coordinate within f32 roundoff of a voxel border or half-voxel may fall
    on the other side in one package than in the other."""
    over = ONE_AT_A_TIME[name]
    if over is None or name.startswith("moreDA defaults"):
        jcfg = dataclasses.replace(ja.AugmentConfig(), spatial_mode="gather", **(over or {}))
        tcfg = dataclasses.replace(ta.AugmentConfig(), **(over or {}))
    else:
        jcfg = dataclasses.replace(ja.NO_AUGMENT, spatial_mode="gather", **over)
        tcfg = dataclasses.replace(ta.NO_AUGMENT, **over)
    rng = np.random.RandomState(len(name))
    shape = SHAPES.get(name, (12, 14, 10, 2))
    data = (rng.rand(*shape) * 2 - 0.3).astype(np.float32)
    seg = rng.randint(0, 3, size=shape[:-1]).astype(np.int8)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want_d, want_s = ja._augment_one(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
        params, noise = _jax_draws(key, jcfg, shape)
        got_d, got_s = ta.apply_params(
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(data, -1, 0)))[None],
            torch.from_numpy(seg)[None], params, tcfg, noise)
        assert got_s.dtype == torch.int8
        d_off = np.abs(got_d[0].numpy() - np.moveaxis(np.asarray(want_d), -1, 0)) > 1e-4
        s_off = got_s[0].numpy() != np.asarray(want_s)
        assert d_off.mean() <= 1e-3 and s_off.mean() <= 1e-3, (seed, d_off.mean(),
                                                                s_off.mean())


def _binom_ok(frac, p, n):
    return abs(frac - p) < 4 * math.sqrt(p * (1 - p) / n) + 1e-9


def test_draws_fire_at_moreDA_rates_and_ranges():
    n = 4000
    cfg = ta.AugmentConfig()
    p = ta.draw_params(n, 3, cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    rotated = (p["angles"] != 0).any(1).float().mean().item()
    assert _binom_ok(rotated, cfg.p_rot, n)
    assert p["angles"].abs().max() <= cfg.rot_max
    scaled = p["scale"][p["scale"] != 1.0]
    assert _binom_ok(len(scaled) / n, cfg.p_scale, n)
    assert scaled.min() >= 0.7 and scaled.max() <= 1.4
    lowres = p["lowres"][p["lowres"] != 1.0]
    assert _binom_ok(len(lowres) / n, cfg.p_lowres, n) and lowres.max() <= 2.0
    for name, prob in (("noise", 0.1), ("blur", 0.2), ("brightness", 0.15),
                       ("contrast", 0.15), ("gamma_inverted", 0.1), ("gamma", 0.3)):
        assert _binom_ok(p[f"do_{name}"].float().mean().item(), prob, n), name
    assert 0.7 <= p["gamma"].min() and p["gamma"].max() <= 1.5
    assert 0.5 <= p["blur"].min() and p["blur"].max() <= 1.0
    for a in range(3):
        assert _binom_ok(p["mirror"][:, a].float().mean().item(), 0.5, n)


def test_augment_batch_keeps_shapes_and_repeats_for_a_seed():
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.rand(4, 1, 12, 14, 10).astype(np.float32))
    seg = torch.from_numpy(rng.randint(0, 3, size=(4, 12, 14, 10)).astype(np.int8))
    outs = [ta.augment_batch(data, seg, ta.AugmentConfig(),
                             torch.Generator().manual_seed(3)) for _ in range(2)]
    assert outs[0][0].shape == data.shape and outs[0][1].dtype == torch.int8
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert set(np.unique(outs[0][1].numpy())) <= {-1, 0, 1, 2}
