"""The port's GenericUNet (lifelong_nnunet_tpu_torch/models/unet.py) against
the JAX GenericUNet with identical weights: flax initializes, the port's
converter maps the tree, and every deep-supervision output must agree on
the CPU in float32, on both of the port's routes (kernel wrappers, which
take their plain versions on the CPU, and the plain composition)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.models.unet import ds_scale_factors as jax_ds_scale_factors
from lifelong_nnunet_tpu.models.unet import unet_from_plans as jax_unet_from_plans
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import (GenericUNet, InstanceNorm,
                                                   ds_scale_factors, unet_from_plans)

torch.set_num_threads(2)

CONFIGS = [
    # (name, pools, kernels, in_ch, spatial), as tests/test_model_parity_torch.py
    ("3d_iso", ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3, 1, (16, 16, 16)),
    ("3d_aniso", ((1, 2, 2), (2, 2, 2)), ((1, 3, 3), (3, 3, 3), (3, 3, 3)),
     2, (8, 16, 16)),
    ("2d", ((2, 2), (2, 2)), ((3, 3),) * 3, 1, (24, 24)),
]


def _pair(pools, kernels, in_ch, spatial, use_kernels=True):
    jm = JaxUNet(num_classes=3, pool_op_kernel_sizes=pools,
                 conv_kernel_sizes=kernels, base_num_features=4,
                 max_num_features=16, dtype=jnp.float32)
    x = np.random.RandomState(0).normal(size=(2,) + spatial + (in_ch,)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = GenericUNet(in_ch, 3, pools, kernels, base_num_features=4,
                     max_num_features=16, use_kernels=use_kernels)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    return jm, params, tm.eval(), x


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name,pools,kernels,in_ch,spatial", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_deep_supervision_outputs_match_jax(name, pools, kernels, in_ch, spatial,
                                            use_kernels):
    jm, params, tm, x = _pair(pools, kernels, in_ch, spatial, use_kernels)
    jax_outs = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        outs = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    assert len(outs) == len(jax_outs) == len(pools)
    for i, (o, jo) in enumerate(zip(outs, jax_outs)):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(np.moveaxis(o.numpy(), 1, -1), np.asarray(jo),
                                   atol=2e-4, rtol=1e-3, err_msg=f"DS output {i}")


@pytest.mark.parametrize("name,pools,kernels,in_ch,spatial", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_module_names_and_order_match_jax(name, pools, kernels, in_ch, spatial):
    jm, params, tm, _ = _pair(pools, kernels, in_ch, spatial)
    assert tm.module_order() == jm.module_order()
    assert [n for n, _ in tm.named_children()] == jm.module_order()
    assert sorted(params) == sorted(jm.module_order())
    assert {n for n, _ in tm.enc0.named_children()} == {"block0", "block1"}


def test_deep_supervision_off_returns_full_resolution_head():
    pools, kernels = ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3
    jm, params, tm, x = _pair(pools, kernels, 1, (16, 16, 16))
    tm.deep_supervision = False
    with torch.no_grad():
        (out,) = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    ref = jm.apply({"params": params}, jnp.asarray(x))[0]
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(ref),
                               atol=2e-4, rtol=1e-3)


def test_f64_plain_route_is_f64_throughout():
    """An f64 plain-route model keeps f64 InstanceNorm statistics and f64
    logits: on a channel whose mean is 3e3 times its spread, where one-pass
    f32 statistics lose the variance (errors of order 1), it agrees with
    torch's two-pass f64 ``instance_norm`` to 1e-7, and it matches the f32
    model on plain data to 1e-4 (f32 roundoff)."""
    gen = torch.Generator().manual_seed(2)
    norm = InstanceNorm(3).double()
    x = 3e3 + torch.randn(2, 3, 6, 7, 8, generator=gen, dtype=torch.float64)
    ref = torch.nn.functional.instance_norm(x, eps=norm.eps)
    torch.testing.assert_close(norm(x), ref, atol=1e-7, rtol=0)
    pools, kernels = ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3
    _, _, tm, x = _pair(pools, kernels, 1, (16, 16, 16), use_kernels=False)
    xc = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        outs32 = tm(xc)
        tm64 = GenericUNet(1, 3, pools, kernels, base_num_features=4, max_num_features=16,
                           dtype=torch.float64, use_kernels=False).double()
        tm64.load_state_dict(tm.state_dict())
        outs64 = tm64(xc)
    for o32, o64 in zip(outs32, outs64):
        assert o64.dtype == torch.float64
        torch.testing.assert_close(o64.float(), o32, atol=1e-4, rtol=1e-4)


def test_converter_rejects_a_foreign_tree():
    pools, kernels = ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3
    _, params, _, _ = _pair(pools, kernels, 1, (16, 16, 16))
    wider = GenericUNet(1, 3, pools, kernels, base_num_features=8,
                        max_num_features=16)
    with pytest.raises(ValueError, match="do not fit"):
        jax_params_to_state_dict(params, wider)


def test_seeded_init_is_deterministic_and_he_scaled():
    pools, kernels = ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3
    a = GenericUNet(1, 3, pools, kernels, 8, 32,
                    generator=torch.Generator().manual_seed(5))
    b = GenericUNet(1, 3, pools, kernels, 8, 32,
                    generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.dec1.block1.conv.weight.detach()             # fan-in 27 * 8
    assert abs(float(w.std()) - (2.0 / (27 * 8)) ** 0.5) < 0.02
    assert float(w.abs().max()) <= 2 * (2.0 / (27 * 8)) ** 0.5 / 0.8796 + 1e-6


def test_unet_from_plans_and_ds_factors_match_jax(synthetic_task, tmp_path):
    from lifelong_nnunet_tpu.planning.fingerprint import analyze_dataset
    from lifelong_nnunet_tpu.planning.plans import plan_experiment
    plans = plan_experiment(analyze_dataset(synthetic_task))
    jm = jax_unet_from_plans(plans, "3d_fullres")
    tm = unet_from_plans(plans, "3d_fullres")
    assert tm.pool_op_kernel_sizes == jm.pool_op_kernel_sizes
    assert tm.conv_kernel_sizes == jm.conv_kernel_sizes
    assert tm.num_classes == jm.num_classes
    assert [tm.stage_features(s) for s in range(tm.num_pool + 1)] == \
        [jm.stage_features(s) for s in range(jm.num_pool + 1)]
    assert ds_scale_factors(tm.pool_op_kernel_sizes) == \
        jax_ds_scale_factors(jm.pool_op_kernel_sizes)
