"""moreDA's elastic deformation in the port (data/augment.py) against the JAX
package's: the cubic resize of the coarse field against
``jax.image.resize(method="cubic")``, the JAX test's three checks of the
field (applied, bounded, smooth; tests/test_cl_trainers.py) on the port's
``augment_batch``, the new draws' gate rate and ranges, the other draws
unchanged by them, and data-parallel ranks' rows of one global batch.
``_augment_one`` with the JAX draws is held to ``apply_params`` in
tests/test_torch_data.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.data import augment as ta

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("coarse,patch", [
    ((14, 20, 14), (56, 80, 56)),      # the hippocampus patch at elastic_grid 4
    ((2, 3, 2), (8, 14, 10)),          # max(2, s // 4) on a small patch
    ((3, 3, 2), (12, 14, 10)),
    ((20, 14), (80, 56)),              # the 2d configuration's patch
    ((12, 14, 10), (12, 14, 10)),      # elastic_grid 1: no axis changes
])
def test_resize_cubic_matches_jax_image_resize(coarse, patch):
    dim = len(patch)
    field = np.random.RandomState(sum(coarse)).uniform(
        -1, 1, (dim,) + coarse).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(field), (dim,) + patch, method="cubic"))
    got = ta.resize_cubic(torch.from_numpy(field)[None], patch)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cubic_weights_are_keys_at_a_half():
    """Each column sums to 1; 2 -> 8 reaches past the input's extent (the
    field overshoots), which F.interpolate's clamped a=-0.75 rule does not."""
    w = ta.cubic_weights(2, 8)
    torch.testing.assert_close(w.sum(0), torch.ones(8), rtol=0, atol=1e-6)
    assert (w < 0).any()
    assert torch.equal(ta.cubic_weights(5, 5), ta.cubic_weights(5, 5).diag().diag())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_elastic_field_is_applied_bounded_and_smooth(seed):
    """The checks of tests/test_cl_trainers.py::test_elastic_augmentation_field
    on the port: elastic alone on a ramp along the first axis."""
    ramp = np.tile(np.linspace(0, 1, 32)[:, None, None], (1, 32, 32)).astype(np.float32)
    data = torch.from_numpy(ramp)[None, None]
    seg = torch.zeros((1, 32, 32, 32), dtype=torch.int8)
    cfg = dataclasses.replace(ta.NO_AUGMENT, do_elastic=True, p_eldef=1.0,
                              elastic_magnitude=(4.0, 4.0))
    d, s = ta.augment_batch(data, seg, cfg, torch.Generator().manual_seed(seed))
    disp = ((d[0, 0].numpy() - ramp) * 31)[6:-6, 6:-6, 6:-6]
    assert np.abs(disp).mean() > 0.5          # field actually applied
    assert np.abs(disp).max() < 6.0           # bounded (cap 4 + interp overshoot)
    assert np.abs(np.diff(disp, axis=0)).mean() < 1.0  # smooth
    assert set(np.unique(s.numpy())) <= {-1, 0}


def _binom_ok(frac, p, n):
    return abs(frac - p) < 4 * math.sqrt(p * (1 - p) / n) + 1e-9


def test_elastic_draws_fire_at_p_eldef_within_their_ranges():
    n = 4000
    cfg = dataclasses.replace(ta.AugmentConfig(), do_elastic=True)
    p = ta.draw_params(n, 3, cfg, torch.Generator().manual_seed(0), CPU, patch=(12, 14, 10))
    assert _binom_ok(p["do_elastic"].float().mean().item(), cfg.p_eldef, n)
    assert p["elastic"].shape == (n,) and p["do_elastic"].dtype == torch.bool
    assert 0.0 <= p["elastic"].min() and p["elastic"].max() < 6.0
    assert p["elastic"].mean().item() == pytest.approx(3.0, abs=0.15)
    assert p["elastic_field"].shape == (n, 3, 3, 3, 2)
    assert -1.0 <= p["elastic_field"].min() and p["elastic_field"].max() < 1.0
    grid2 = dataclasses.replace(cfg, elastic_grid=8)
    p2 = ta.draw_params(2, 2, grid2, torch.Generator().manual_seed(0), CPU, patch=(80, 56))
    assert p2["elastic_field"].shape == (2, 2, 10, 7)
    with pytest.raises(ValueError):
        ta.draw_params(2, 3, cfg, torch.Generator().manual_seed(0), CPU)


# draw_params(4, dim, AugmentConfig(), Generator().manual_seed(11)) before the
# elastic draws were added, and the generator's next two draws after it
PINNED = {
    3: {"scale": [1.3096323013305664, 1.0, 1.0, 1.0],
        "lowres": [1.0, 1.630070686340332, 1.0, 1.0],
        "contrast": [0.8762307167053223, 1.0135784149169922, 1.1640522480010986,
                     0.9978175163269043],
        "do_contrast": [False, True, True, False],
        "do_gamma_inverted": [False, False, False, True],
        "mirror": [[True, True, True], [True, False, False], [False, True, True],
                   [False, True, False]],
        "next": [0.26588720083236694, 0.4478825330734253]},
    2: {"angles": [[0.0], [0.0], [0.0], [-0.34724920988082886]],
        "lowres": [1.8709032535552979, 1.0, 1.0, 1.0],
        "gamma_inverted": [0.9019690752029419, 1.1217254400253296, 1.3624836206436157,
                           1.0965080261230469],
        "do_blur": [False, True, False, False],
        "mirror": [[False, False], [False, True], [True, True], [False, False]],
        "next": [0.30372732877731323, 0.008904993534088135]},
}


@pytest.mark.parametrize("dim", [3, 2])
def test_draws_without_elastic_are_unchanged(dim):
    gen = torch.Generator().manual_seed(11)
    p = ta.draw_params(4, dim, ta.AugmentConfig(), gen, CPU)
    assert not any(k.endswith("elastic") or k.startswith("elastic") for k in p)
    for k, v in PINNED[dim].items():
        got = torch.rand(2, generator=gen) if k == "next" else p[k]
        assert got.tolist() == v, k


@pytest.mark.parametrize("dim", [3, 2])
def test_elastic_draws_come_after_every_other_draw(dim):
    """With elastic on, every other parameter is the same tensor as with it
    off, for the same seed."""
    patch = (12, 14, 10)[:dim]
    off = ta.draw_params(5, dim, ta.AugmentConfig(), torch.Generator().manual_seed(2), CPU)
    on = ta.draw_params(5, dim, dataclasses.replace(ta.AugmentConfig(), do_elastic=True),
                        torch.Generator().manual_seed(2), CPU, patch=patch)
    assert set(on) - set(off) == {"elastic", "do_elastic", "elastic_field"}
    for k, v in off.items():
        assert torch.equal(on[k], v), k


@pytest.mark.parametrize("shape", [(4, 1, 12, 14, 10), (4, 2, 20, 14)])
def test_two_ranks_rows_give_one_ranks_batch(shape):
    """rows=(lo, hi, B): two data-parallel ranks, each drawing the global
    batch's parameters from one seed, give the rows one rank augments."""
    rng = np.random.RandomState(1)
    data = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    seg = torch.from_numpy(rng.randint(0, 3, size=shape[:1] + shape[2:]).astype(np.int8))
    cfg = dataclasses.replace(ta.AugmentConfig(), do_elastic=True, p_eldef=0.5)
    whole = ta.augment_batch(data, seg, cfg, torch.Generator().manual_seed(7))
    ranks = [ta.augment_batch(data[lo:hi], seg[lo:hi], cfg, torch.Generator().manual_seed(7),
                              rows=(lo, hi, 4)) for lo, hi in ((0, 2), (2, 4))]
    params = ta.draw_params(4, len(shape) - 2, cfg, torch.Generator().manual_seed(7), CPU,
                            patch=shape[2:])
    assert params["do_elastic"].any()         # the field moves some rows
    assert torch.equal(torch.cat([r[0] for r in ranks]), whole[0])
    assert torch.equal(torch.cat([r[1] for r in ranks]), whole[1])
