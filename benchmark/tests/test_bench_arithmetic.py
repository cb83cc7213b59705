"""The yardstick's arithmetic against hand counts for a small U-Net of
each configuration's topology, and the trace reduction on made-up
intervals."""

import pytest

from lifelong_nnunet_tpu_torch.models.unet import unet_from_plans

from benchmark import arithmetic as ar
from benchmark.tests.cells import files
from benchmark.tests.test_bench_reference import _plans

# the tiny 3D U-Net (patch 16^3, two [2,2,2] pools, features 4-8-16), by hand:
# 2 * taps * out voxels * cin * cout per conv, 2 * 8 * in voxels * cin * cout
# per transposed conv, 2 * voxels * cin * cout per head (batch 1)
HAND_3D = {"enc0.block0": 2 * 27 * 4096 * 1 * 4, "enc0.block1": 2 * 27 * 4096 * 4 * 4,
           "enc1.block0": 2 * 27 * 512 * 4 * 8, "enc1.block1": 2 * 27 * 512 * 8 * 8,
           "bottleneck.block0": 2 * 27 * 64 * 8 * 16, "bottleneck.block1": 2 * 27 * 64 * 16 * 16,
           "up0": 2 * 8 * 64 * 16 * 8, "dec0.block0": 2 * 27 * 512 * 16 * 8,
           "dec0.block1": 2 * 27 * 512 * 8 * 8, "seg0": 2 * 512 * 8 * 3,
           "up1": 2 * 8 * 512 * 8 * 4, "dec1.block0": 2 * 27 * 4096 * 8 * 4,
           "dec1.block1": 2 * 27 * 4096 * 4 * 4, "seg1": 2 * 4096 * 4 * 3}
# the tiny 2D U-Net (patch 32^2, three [2,2] pools, features 4-8-16-24)
F2 = [4, 8, 16, 24]
N2 = [1024, 256, 64, 16]


def _hand_2d(serve: bool) -> int:
    enc = sum(2 * 9 * N2[s] * (1 if s == 0 else F2[s - 1]) * F2[s] + 2 * 9 * N2[s] * F2[s] ** 2
              for s in range(4))
    dec = 0
    for d in range(3):
        s = 2 - d
        dec += 2 * 4 * N2[s + 1] * F2[s + 1] * F2[s]            # transposed conv
        dec += 2 * 9 * N2[s] * 2 * F2[s] * F2[s] + 2 * 9 * N2[s] * F2[s] ** 2
        if not serve or d == 2:
            dec += 2 * N2[s] * F2[s] * 3
    return enc + dec


def test_layer_flops_by_hand_3d():
    _, config, _ = files("tiny3d_train")
    got = {la.name: la.conv_flops(1) for la in ar.layers_of(config, True)}
    assert got == HAND_3D
    assert ar.model_flops(config, 2, True) == 3 * 2 * sum(HAND_3D.values())
    assert ar.model_flops(config, 8, False) == 8 * (sum(HAND_3D.values()) - HAND_3D["seg0"])


@pytest.mark.parametrize("serve", [False, True])
def test_model_flops_by_hand_2d(serve):
    _, config, _ = files("tiny2d_train")
    want = _hand_2d(serve) * (1 if serve else 3 * 4)
    assert ar.model_flops(config, 1 if serve else 4, not serve) == want


@pytest.mark.parametrize("name,fused,norms", [
    # 3D train: 8 fused blocks forward + 7 data gradients (not the first
    # layer's); 2 strided blocks' InstanceNorm forward + all 10 backward
    ("tiny3d_train", (15, 8), (12, 2)),
    # 2D: no fused block; 14 blocks' InstanceNorm forward + 14 backward
    ("tiny2d_train", (0, 0), (28, 14))])
def test_launch_counts_by_hand(name, fused, norms):
    _, config, _ = files(name)
    b = config["plans"]["configurations"][config["config_name"]]["batch_size"]
    assert len(ar.conv3d_fused_launches(config, b, True)) == fused[0]
    assert len(ar.conv3d_fused_launches(config, b, False)) == fused[1]
    assert len(ar.instance_norm_launches(config, b, True)) == norms[0]
    assert len(ar.instance_norm_launches(config, b, False)) == norms[1]


@pytest.mark.parametrize("name", ["tiny3d_train", "tiny2d_train"])
def test_fused_blocks_are_the_programs(name):
    """The blocks the arithmetic calls fused are those the program routes
    to the fused kernel."""
    _, config, _ = files(name)
    net = unet_from_plans(_plans(config), config["config_name"])
    cfg = config["plans"]["configurations"][config["config_name"]]
    for la in ar.layers_of(config, True):
        if la.kind != "block":
            continue
        block = net.get_submodule(la.name)
        shape = (cfg["batch_size"], la.cin) + la.in_spatial
        assert (block.route(shape) == "fused") == la.fused, la.name


def test_fused_launch_work_by_hand():
    _, config, _ = files("tiny3d_train")
    first = ar.conv3d_fused_launches(config, 2, False)[0]        # enc0.block0: 1 -> 4 at 16^3
    assert first == (2 * 2 * 27 * 4096 * 1 * 4,
                     2 * 2 * (1 + 4) * 4096 + 4 * 1 * 4 * 27 + 4 * 2 * 4)


def test_bound():
    assert ar.bound_s(989e12, 0) == pytest.approx(1.0)
    assert ar.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert ar.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_trace_reduction():
    dev = [("k1", 0, 10), ("k2", 5, 20), ("k1", 30, 40), ("k3", 60, 65)]
    tr = ar.reduce_trace(dev, 100e-6)
    assert tr["busy_s"] == pytest.approx(35e-6)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["by_name"]["k1"] == pytest.approx(20e-6)
    assert tr["device_ops"][0][0] in ("k1", "k2")
    assert ar.kernel_seconds(tr["by_name"], ("k1", "k3")) == pytest.approx(25e-6)


def test_idle_gaps_named_by_host_span_or_next_operation():
    dev = [("k1", 0, 10), ("k2", 5, 20), ("k1", 30, 40), ("k3", 60, 65)]
    host = [("step", 0, 100), ("aten::copy_", 41, 59)]
    assert ar.named_gaps(dev, host, 0, 100) == [
        ["step", pytest.approx(35e-6)], ["aten::copy_", pytest.approx(20e-6)],
        ["step", pytest.approx(10e-6)]]
    assert ar.named_gaps(dev, [], 0, 100) == [
        ["after the last device operation", pytest.approx(35e-6)],
        ["before k3", pytest.approx(20e-6)], ["before k1", pytest.approx(10e-6)]]
