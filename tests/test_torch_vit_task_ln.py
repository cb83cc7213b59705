"""The port's task-specific ViT LayerNorms against the JAX package's on the
CPU, f32: ``TaskLayerNorm`` with ``ln_tasks = ("A", "B")`` and the
ViT-U-Net of ``tests/test_vit.py:tiny_vit_unet`` with those LayerNorms, at
each task index, the two sets made different: outputs and every gradient
against flax's through ``models/convert.py`` (``ln_<task>`` ->
``ln.<task>``).  The trainers with these LayerNorms are held to JAX's in
``tests/test_torch_cl_task_ln.py``.  Each tolerance is stated where it is
used."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.models import vit as jvit
from lifelong_nnunet_tpu_torch.models import vit as tvit
from lifelong_nnunet_tpu_torch.models.convert import _vit_entries, jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.vit_unet import GenericViTUNet
from tests.test_vit import tiny_vit_unet

torch.set_num_threads(4)

TASKS = ("A", "B")
CONV_PERM = (4, 3, 0, 1, 2)


def _perturbed(params, seed=0):
    """``params`` with every LayerNorm set moved apart from the others."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), params)


@pytest.mark.parametrize("idx", [0, 1], ids=["task_A", "task_B"])
def test_task_layer_norm_matches_jax(idx):
    """One TaskLayerNorm with two sets: output to 1e-5, the input's and each
    set's gradient to 1e-5 (the other set's gradient is 0 on both sides)."""
    x = np.random.RandomState(1).normal(size=(2, 10, 32)).astype(np.float32) * 2 + 3
    g = np.random.RandomState(2).normal(size=x.shape).astype(np.float32)
    jm = jvit.TaskLayerNorm(ln_tasks=TASKS)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), idx)["params"])
    assert sorted(params) == ["ln_A", "ln_B"]

    def f(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, idx) * g)
    jout = jm.apply({"params": params}, jnp.asarray(x), idx)
    jgp, jgx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    tm = tvit.TaskLayerNorm(32, TASKS)
    tm.load_state_dict({k[len("vit.norm."):]: torch.tensor(v) for k, v in
                        _vit_entries({"norm": params}, CONV_PERM).items()})
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, torch.float32, idx)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    want = {k[len("vit.norm."):]: v for k, v in _vit_entries({"norm": jax.tree.map(
        np.asarray, jgp)}, CONV_PERM).items()}
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name], atol=1e-5, rtol=1e-5, err_msg=name)
        assert (p.grad is None) == (name.split(".")[1] != TASKS[idx]), name


@pytest.mark.parametrize("idx", [0, 1], ids=["task_A", "task_B"])
def test_vit_unet_task_lns_match_jax(idx):
    """``tests/test_vit.py:84``'s model at ``active_task_idx`` ``idx``: every
    deep-supervision output to 1e-4 + 1e-3 relative, every gradient of a
    weighted sum of them to 1e-4 of its scale (the InstanceNorm-absorbed
    conv biases to 1e-4 of their weight's, at least 1e-6); the other task's
    LayerNorms get no gradient."""
    jm = tiny_vit_unet("V1", ln_tasks=TASKS, active_task_idx=idx)
    x = np.random.RandomState(3).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    params = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x))["params"]))
    outs = jm.apply({"params": params}, jnp.asarray(x))
    ws = [np.random.RandomState(4 + i).normal(size=o.shape).astype(np.float32)
          for i, o in enumerate(outs)]

    def f(p):
        return sum(jnp.sum(o * w) for o, w in zip(jm.apply({"params": p}, jnp.asarray(x)), ws))
    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(f))(params))
    tm = GenericViTUNet(1, 3, ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3, (16, 16, 16), 4, 16,
                        vit_embed_dim=32, vit_depth=2, vit_heads=2, ln_tasks=TASKS,
                        active_task_idx=idx)
    tm.load_state_dict(jax_params_to_state_dict(params, tm))
    touts = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    for o, jo in zip(touts, outs):
        np.testing.assert_allclose(np.moveaxis(o.detach().numpy(), 1, -1), np.asarray(jo),
                                   atol=1e-4, rtol=1e-3)
    sum((o * torch.from_numpy(np.ascontiguousarray(np.moveaxis(w, -1, 1)))).sum()
        for o, w in zip(touts, ws)).backward()
    want = jax_params_to_state_dict(jgrads, tm)
    other = f".ln.{TASKS[1 - idx]}."
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = want[name[:-4] + "weight" if name.endswith("conv.bias") else name]
        limit = 1e-4 * scale.abs().max().item() + 1e-8
        if name.endswith("conv.bias"):
            limit = max(limit, 1e-6)
        assert (got - want[name]).abs().max().item() <= limit, name
        if other in name:
            assert p.grad is None, name
