"""The port's multi-head partition (models/multihead.py) over ``state_dict``
keys against the JAX package's ``split_params`` over flax paths, on the
same U-Net, and against the rule the JAX package cites from the reference
(``lifelong_nnunet_tpu/models/multihead.py:71-87``): the head is every
parameter at or after, in topological module order, the first one that
matches the split spec."""

import jax
import jax.numpy as jnp
import pytest
import torch

from lifelong_nnunet_tpu.models.multihead import flatten, split_params as jax_split
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu_torch.models.multihead import MultiHeadParams, split_params
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet

POOLS = ((2, 2, 2), (2, 2, 2))
CONVS = ((3, 3, 3),) * 3
LEAF = {"conv.weight": "Conv_0/kernel", "conv.bias": "Conv_0/bias",
        "norm.weight": "InstanceNorm_0/scale", "norm.bias": "InstanceNorm_0/bias",
        "weight": "kernel", "bias": "bias"}


def _jax_path(key: str) -> str:
    """A port ``state_dict`` key -> the JAX model's flax parameter path."""
    for tail, jtail in LEAF.items():
        if key.endswith("." + tail):
            return key[: -len(tail) - 1].replace(".", "/") + "/" + jtail
    raise KeyError(key)


@pytest.fixture(scope="module")
def models():
    port = GenericUNet(1, 3, POOLS, CONVS, 4, 16)
    jmodel = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                     base_num_features=4, max_num_features=16)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))["params"]
    assert sorted(map(_jax_path, port.state_dict())) == sorted(flatten(params))
    return port, jmodel, params


@pytest.mark.parametrize("spec", ["seg_outputs", "seg", "dec1", "up1", "bottleneck",
                                  "enc1", "dec0.block1"])
def test_split_matches_the_jax_split(models, spec):
    port, jmodel, params = models
    body, head = split_params(port.state_dict(), spec, port.module_order())
    jbody, jhead = jax_split(params, spec.replace(".", "/"), jmodel.module_order())
    assert sorted(map(_jax_path, body)) == sorted(jbody)
    assert sorted(map(_jax_path, head)) == sorted(jhead)
    # the reference rule: everything from the first match on, in module order
    order = port.module_order()
    first = min(order.index(k.split(".")[0]) for k in head)
    assert all(order.index(k.split(".")[0]) < first for k in body if
               k.split(".")[0] != order[first])
    assert all(order.index(k.split(".")[0]) >= first for k in head)


def test_default_split_puts_every_seg_head_in_the_head(models):
    port = models[0]
    body, head = split_params(port.state_dict(), "seg_outputs", port.module_order())
    assert {k.split(".")[0] for k in head} == {"seg0", "seg1"}
    assert not any(k.startswith("seg") for k in body)


def test_unknown_spec_raises(models):
    port = models[0]
    with pytest.raises(ValueError, match="matches no parameter"):
        split_params(port.state_dict(), "nowhere", port.module_order())


def test_registry_create_add_assemble_absorb(models):
    port = models[0]
    sd = port.state_dict()
    mh = MultiHeadParams.create(sd, "seg_outputs", port.module_order(), "A")
    assert mh.tasks == ["A"] and mh.active_task == "A"
    with torch.no_grad():                  # the registry holds copies
        port.seg0.weight.add_(1.0)
    assert not torch.equal(mh.assemble()["seg0.weight"], port.seg0.weight)
    trained = {k: v + 1.0 for k, v in mh.assemble().items()}
    mh = mh.absorb(trained)
    assert all(torch.equal(mh.assemble()[k], trained[k]) for k in trained)
    fresh = mh.add_new_task("B")                       # Multi-Head: from state_init
    assert torch.equal(fresh.assemble("B")["seg0.weight"], mh.state_init["seg0.weight"])
    assert torch.equal(fresh.assemble("B")["enc0.block0.conv.weight"],
                       trained["enc0.block0.conv.weight"])
    moved = mh.add_new_task("C", use_init=False)       # Sequential: the active head
    assert torch.equal(moved.assemble("C")["seg1.bias"], trained["seg1.bias"])
    assert moved.tasks == ["A", "C"] and moved.add_new_task("A").active_task == "A"
