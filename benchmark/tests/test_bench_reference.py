"""The plain reference against the program at tiny sizes on the CPU, piece
by piece: the U-Net forward, the loss, the sampler, the augmentation, the
sliding window, and the NIfTI files; and the control's float8 rounding."""

import os

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.data.augment import AugmentConfig, augment_batch
from lifelong_nnunet_tpu_torch.data.dataset import PreprocessedDataset
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.inference.sliding_window import predict_sliding_window
from lifelong_nnunet_tpu_torch.models.unet import unet_from_plans
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss
from lifelong_nnunet_tpu_torch.planning.plans import Configuration, Plans
from lifelong_nnunet_tpu_torch.utilities import nifti

from benchmark import data
from benchmark.entries import common
from benchmark.reference import inputs, model, serve, train
from benchmark.tests.cells import files
from benchmark.topology import ds_factors

CONFIGS = {"3d": "tiny3d_train", "2d": "tiny2d_train"}


def _plans(config) -> Plans:
    d = dict(config["plans"])
    d["configurations"] = {k: Configuration(**v) for k, v in d["configurations"].items()}
    for key in ("modalities", "labels", "normalization_schemes", "use_mask_for_norm",
                "intensity_properties"):
        d[key] = {int(k): v for k, v in d[key].items()}
    return Plans(**d)


def _setup(kind, seed=5):
    _, config, traffic = files(CONFIGS[kind])
    cfg = config["plans"]["configurations"][config["config_name"]]
    net = unet_from_plans(_plans(config), config["config_name"])
    params = model.init_params(model.layers_for(config, True), seed, "cpu")
    common.load_params(net, params)
    return config, traffic, cfg, net, params


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_forward_matches_program(kind):
    config, _, cfg, net, params = _setup(kind)
    x = torch.randn((2, 1) + tuple(cfg["patch_size"]), generator=torch.Generator().manual_seed(1))
    prog = net(x)
    ref = model.forward(params, x, model.layers_for(config, True))
    assert len(prog) == len(ref)
    for a, b in zip(prog, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_loss_matches_program(kind):
    config, _, cfg, net, params = _setup(kind)
    g = torch.Generator().manual_seed(2)
    patch = tuple(cfg["patch_size"])
    outs = [torch.randn((2, 3) + tuple(p // f for p, f in zip(patch, fac)), generator=g)
            for fac in ds_factors(cfg)]
    target = torch.randint(-1, 3, (2,) + patch, generator=g)
    prog = deep_supervision_loss(outs, target, ds_factors(cfg), batch_dice=True)
    ref = train.ds_loss(outs, target, ds_factors(cfg))
    torch.testing.assert_close(prog, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,native", [("3d", True), ("3d", False), ("2d", False)])
def test_sampler_matches_program(kind, native, tmp_path):
    _, config, traffic = files(CONFIGS[kind])
    cfg = config["plans"]["configurations"][config["config_name"]]
    names = data.write_stage(str(tmp_path), config, traffic["case_shapes"], 7, "cpu")
    ds = PreprocessedDataset(str(tmp_path))
    prog = PatchSampler(ds, names, cfg["patch_size"], cfg["batch_size"], 0.33, seed=1,
                        native=native)
    arrays = [ds.load(n) for n in names]
    ref = inputs.Sampler(arrays, [ds.class_locations(n) for n in names], cfg["patch_size"],
                         cfg["batch_size"], 0.33, 1)
    for _ in range(4):
        b = prog.next_batch()
        d, s = ref.next_batch()
        np.testing.assert_array_equal(b["data"], d)
        np.testing.assert_array_equal(b["seg"], s)


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_augmentation_matches_program(kind):
    _, _, cfg, _, _ = _setup(kind)
    g = torch.Generator().manual_seed(3)
    shape = (4, 1) + tuple(cfg["patch_size"])
    x = torch.randn(shape, generator=g)
    seg = torch.randint(-1, 3, (shape[0],) + shape[2:], generator=g).to(torch.int8)
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(3):           # the generators advance alike, step after step
        pd, ps = augment_batch(x, seg, AugmentConfig(), ga)
        rd, rs = inputs.augment(x, seg, gb)
        torch.testing.assert_close(pd, rd, rtol=1e-5, atol=1e-5)
        assert torch.equal(ps, rs)
        assert torch.equal(ga.get_state(), gb.get_state())


def test_sliding_window_matches_program():
    config, _, cfg, net, params = _setup("3d")
    net.eval()
    image = torch.randn((1, 20, 30, 17), generator=torch.Generator().manual_seed(4))
    prog = predict_sliding_window(net, image.movedim(0, -1).numpy(), cfg["patch_size"], 3,
                                  device=torch.device("cpu"), window_batch=3)
    ref = serve.probabilities(params, model.layers_for(config, False), image, cfg["patch_size"],
                              tuple((0, n) for n in image.shape[1:]))
    np.testing.assert_allclose(prog, ref.movedim(0, -1).numpy(), rtol=1e-4, atol=1e-5)


def test_boxes_take_the_windows_that_cover_them():
    """A cell of the window grid, from the windows that overlap it alone,
    reads as the whole volume's probabilities there."""
    config, _, cfg, _, params = _setup("3d")
    image = torch.randn((1, 20, 30, 17), generator=torch.Generator().manual_seed(4))
    layers = model.layers_for(config, False)
    whole = serve.probabilities(params, layers, image, cfg["patch_size"],
                                tuple((0, n) for n in image.shape[1:]))
    boxes = serve.grid_cells(image.shape[1:], cfg["patch_size"], 3000, np.random.default_rng(3))
    assert len(boxes) == len(set(boxes)) >= 5
    for box in boxes:
        assert all(0 <= a < b <= s for (a, b), s in zip(box, image.shape[1:]))
        part = serve.probabilities(params, layers, image, cfg["patch_size"], box)
        torch.testing.assert_close(part, whole[(slice(None),) + tuple(slice(a, b) for a, b in box)],
                                   rtol=1e-5, atol=1e-6)


def test_grid_cells_tile_the_volume():
    spatial = (525, 512, 100)
    cells = serve.grid_cells(spatial, (128, 128, 128), 10 ** 9, np.random.default_rng(0))
    assert sum(np.prod([b - a for a, b in c]) for c in cells) == np.prod(spatial)
    first = serve.grid_cells(spatial, (128, 128, 128), 4 * 64 ** 3, np.random.default_rng(0))
    held = [np.prod([b - a for a, b in c]) for c in first]
    assert first == cells[:len(first)] and sum(held[:-1]) < 4 * 64 ** 3 <= sum(held)


def test_served_gap():
    probs = torch.tensor([[0.6, 0.2], [0.4, 0.8]])
    assert serve.served_gap(probs, np.array([0, 1])) == 0.0
    assert serve.served_gap(probs, np.array([1, 1])) == pytest.approx(0.2)


@pytest.mark.parametrize("suffix,dtype", [(".nii", np.int16), (".nii.gz", np.uint8)])
def test_nifti_files_read_alike(tmp_path, suffix, dtype):
    arr = (np.arange(4 * 5 * 6) % 100).astype(dtype).reshape(4, 5, 6)
    ours = str(tmp_path / f"a{suffix}")
    data.write_nifti(ours, arr, (1.0, 0.5, 2.0))
    img = nifti.read(ours)
    np.testing.assert_array_equal(img.data, arr)
    assert tuple(img.spacing) == (1.0, 0.5, 2.0)
    theirs = str(tmp_path / f"b{suffix}")
    nifti.write(theirs, nifti.NiftiImage(arr, spacing=(1.0, 1.0, 1.0)))
    np.testing.assert_array_equal(data.read_nifti(theirs), arr)


def test_cases_are_the_seeds():
    a = data.make_case((12, 20, 18), 2 ** 31 + 5, 0, "cpu")
    b = data.make_case((12, 20, 18), 2 ** 31 + 5, 0, "cpu")
    c = data.make_case((12, 20, 18), 2 ** 31 + 6, 0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert set(a[1].unique().tolist()) == {0, 1, 2}


def test_fp8_rounds_forward_and_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = model.fp8(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    g = torch.linspace(0.01, 1.0, 101) / 3
    y.backward(g)
    err = (x.grad - g).abs() / g
    assert 0 < float(err.max()) < 0.2


def test_reference_imports_nothing_of_the_program():
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                assert "lifelong_nnunet_tpu" not in f.read(), name
