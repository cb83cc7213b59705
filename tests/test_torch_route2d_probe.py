"""The helpers of lifelong_nnunet_tpu_torch/tools/route2d_probe.py on the CPU
(the probe itself trains and serves on the card): bf16 ulps, the margins
and their histogram, the error measure, the InstanceNorm that normalizes in
f32, and the per-launch record of a forward, where a CPU tensor takes the
kernel's plain version, so the kernel's errors are 0 and the plain route's
module differs by its bf16 arithmetic."""

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.models.unet import GenericUNet, InstanceNorm
from lifelong_nnunet_tpu_torch.ops.kernels import instance_norm as inorm
from lifelong_nnunet_tpu_torch.tools import route2d_probe as probe

torch.set_num_threads(2)


def test_bf16_ulp():
    v = torch.tensor([1.0, 1.5, 0.5, 3.0, -2.0, 0.0])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -6, 2.0 ** -6, 0.0])
    assert torch.equal(probe.bf16_ulp(v), want)
    # the next bf16 value above x is one ulp above it by this measure
    x = torch.tensor([0.7], dtype=torch.bfloat16)
    up = (x.float() + probe.bf16_ulp(x.float())).to(torch.bfloat16)
    assert up.float().item() > x.float().item()
    assert (x.float() + 0.49 * probe.bf16_ulp(x.float())).to(torch.bfloat16) == x


def test_margins_and_histogram():
    probs = np.array([[0.5, 0.49, 0.01], [0.7, 0.2, 0.1], [0.34, 0.33, 0.33]], np.float32)
    ulps, logr = probe.margins(probs)
    np.testing.assert_allclose(ulps, [0.01 / 2 ** -8, 0.5 / 2 ** -8, 0.01 / 2 ** -9],
                               rtol=1e-4)
    np.testing.assert_allclose(logr, np.log([0.5 / 0.49, 0.7 / 0.2, 0.34 / 0.33]),
                               rtol=1e-5)
    hist = probe.histogram(ulps)
    assert sum(hist.values()) == 3
    assert hist["[2, 4)"] == hist["[4, 8)"] == hist["[64, 256)"] == 1


def test_ulp_errors_count_what_differs():
    ref = torch.tensor([1.0, 0.5, -0.25, 0.0]).to(torch.bfloat16)
    assert probe.ulp_errors(ref, ref) == {"share_differ": 0.0, "max_ulps": 0.0,
                                          "share_over_1_ulp": 0.0}
    got = ref.float().clone()
    got[1] += 3 * 2.0 ** -9                       # 1.5 ulps of 0.5 in bf16
    err = probe.ulp_errors(got, ref, torch.full((4,), 8.0), prefix="k_")
    assert err["k_share_differ"] == 0.25 and err["k_max_ulps"] == pytest.approx(1.5)
    assert err["k_share_over_1_ulp"] == 0.25
    assert err["k_max_term_ulps"] == pytest.approx(3 * 2.0 ** -9 / 2.0 ** -4)
    assert err["k_share_over_1_term_ulp"] == 0.0


def test_f32_norm_is_the_kernels_plain_version():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 8, 9, 7, generator=gen) * 4 + 30).to(torch.bfloat16)
    norm = InstanceNorm(8)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(8, generator=gen) + 0.5)
        norm.bias.copy_(torch.randn(8, generator=gen))
    pre = probe.f32_norm(norm, x)
    want, _, _ = inorm._plain_forward(x, norm.weight, norm.bias, 1.0, norm.eps)
    assert pre.dtype == torch.bfloat16 and torch.equal(pre, want)
    # the module's bf16 arithmetic: a large mean over a small spread
    assert not torch.equal(norm(x), pre)


def test_in_launch_errors_records_every_launch_of_a_forward():
    model = GenericUNet(1, 3, ((2, 2), (2, 2)), ((3, 3),) * 3, 4, 16,
                        dtype=torch.bfloat16, deep_supervision=False,
                        generator=torch.Generator().manual_seed(1)).eval()
    x = torch.randn(2, 1, 16, 12, generator=torch.Generator().manual_seed(2))
    launches = probe.in_launch_errors(model, x.to(torch.bfloat16))
    blocks = [m for m in model.modules() if type(m).__name__ == "ConvNormAct"]
    assert len(launches) == len(blocks) == 10
    assert [r["shape"][:2] for r in launches[:2]] == [[2, 4]] * 2
    assert launches[0]["shape"][2] == 16 * 12
    for r in launches:
        # on the CPU the kernel's wrapper runs its plain version
        assert r["share_differ"] == r["max_ulps"] == r["rstd_rel_err"] == 0.0
        assert r["form"] == []
        assert 0.0 < r["module_share_differ"] <= 1.0
    assert inorm._forward.__name__ == "_forward"          # restored
