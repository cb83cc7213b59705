"""The port's EWC / RW terms (``lifelong_nnunet_tpu_torch/ops/cl_losses.py``)
and its masked optimizer against the JAX package's on the CPU.

The plain penalty functions, the online RW update and the score
normalization match JAX on seeded numpy inputs to 1e-6 relative, masks
and bf16 anchors included, and give the reference formula's hand values
of ``tests/test_cl_losses.py`` (4.4, 2.0, 1.2, 3.7, 1/1.85): the JAX output
alone is not ground truth here (ROADMAP Queue 3).  The train step's
``QuadraticPenalty`` (``torch._foreach_*``, gradient written into
``.grad``) gives the plain function's value and autograd's gradient.
``PolySGD`` with a trainable mask equals optax's masked chain over 3
steps with the clip active, leaves the frozen tensors bit for bit, and
its state round-trips.  ``jax_cl_state_to_torch`` makes both packages'
penalties equal on the same parameters.  The ``cuda``-marked half holds
the foreach penalty and its gradient on the card to the same code on the
CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from lifelong_nnunet_tpu.models import multihead as jmh
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu.training.optimizer import make_optimizer
from lifelong_nnunet_tpu_torch.models.convert import (jax_cl_state_to_torch,
                                                      jax_params_to_state_dict)
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet
from lifelong_nnunet_tpu_torch.ops import cl_losses as pcl
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD

SHAPES = {"enc0.w": (4, 1, 3, 3, 3), "enc0.b": (4,), "vit.norm.w": (16,),
          "seg0.w": (3, 4, 1, 1, 1)}
RTOL = 1e-6


def _t(d):
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _rand(seed, positive=False, scale=1.0):
    rng = np.random.RandomState(seed)
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    return {k: np.abs(v) for k, v in out.items()} if positive else out


def _bf16(d):
    return {k: v.astype(ml_dtypes.bfloat16) for k, v in d.items()}


# ------------------------------------------------------------ hand values
def test_ewc_penalty_hand_value():
    params = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([3.0])}
    state = {"task1": {"fisher": {"a": torch.tensor([2.0, 1.0]), "b": torch.tensor([4.0])},
                       "params": {"a": torch.tensor([0.0, 0.0]), "b": torch.tensor([1.0])}}}
    # lam/2 * (2*1 + 1*4 + 4*4) = 0.4/2 * 22
    assert pcl.ewc_penalty(params, state, 0.4).item() == pytest.approx(4.4, rel=RTOL)


def test_ewc_penalty_mask_hand_value():
    params = {"a": torch.tensor([1.0]), "vit.n": torch.tensor([2.0])}
    state = {"t": {"fisher": {"a": torch.tensor([1.0]), "vit.n": torch.tensor([1.0])},
                   "params": {"a": torch.tensor([0.0]), "vit.n": torch.tensor([0.0])}}}
    # only vit.n: 0.5 * 1 * 4
    assert pcl.ewc_penalty(params, state, 1.0, {"a": False, "vit.n": True}).item() == 2.0


def test_rw_penalty_hand_value():
    # lam (F + S)(theta - theta*)^2 = 0.4 * (2 + 1) * 1, no half
    val = pcl.rw_penalty({"a": torch.tensor([1.0])}, {"a": torch.tensor([2.0])},
                         {"a": torch.tensor([1.0])}, {"a": torch.tensor([0.0])}, lam=0.4)
    assert val.item() == pytest.approx(1.2, rel=RTOL)


def test_rw_online_update_hand_values():
    one = dict(fisher={"a": torch.tensor([1.0])}, scores={"a": torch.tensor([0.0])},
               grads={"a": torch.tensor([2.0])}, prev_params={"a": torch.tensor([0.0])},
               curr_params={"a": torch.tensor([1.0])})
    f, s = pcl.rw_online_update(**one, loss_prev=2.0, loss_curr=torch.tensor(1.0), alpha=0.9)
    assert f["a"].item() == pytest.approx(3.7, rel=RTOL)            # 0.9*4 + 0.1*1
    assert s["a"].item() == pytest.approx(1.0 / 1.85, rel=1e-6)    # (2-1)/(3.7/2 + eps)
    _, s = pcl.rw_online_update(**one, loss_prev=1.0, loss_curr=torch.tensor(2.0))
    assert s["a"].item() == 0.0                                    # negative dloss clamps


def test_normalize_scores_hand_values():
    s = pcl.normalize_scores({"a": torch.tensor([0.0, 5.0]), "b": torch.tensor([10.0])})
    torch.testing.assert_close(s["a"], torch.tensor([0.0, 0.5]))
    torch.testing.assert_close(s["b"], torch.tensor([1.0]))


# ------------------------------------------------------------ against JAX
MASKS = {"none": None, "vit_norm": {k: "vit" in k and "norm" in k for k in SHAPES},
         "not_vit": {k: "vit" not in k for k in SHAPES}}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("anchor_dtype", ["float32", "bfloat16"])
def test_ewc_penalty_matches_jax(mask, anchor_dtype):
    params = _rand(0)
    cast = _bf16 if anchor_dtype == "bfloat16" else (lambda d: d)
    state = {t: {"fisher": cast(_rand(10 + i, positive=True)), "params": cast(_rand(20 + i))}
             for i, t in enumerate(["A", "B"])}
    m = MASKS[mask]
    want = float(jcl.ewc_penalty(_j(params), {t: {k: _j(v) for k, v in s.items()}
                                              for t, s in state.items()}, 0.4, m))
    tstate = {t: {k: {n: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if anchor_dtype == "bfloat16" else torch.float32)
        for n, a in v.items()} for k, v in s.items()} for t, s in state.items()}
    got = pcl.ewc_penalty(_t(params), tstate, 0.4, m)
    assert got.dtype == torch.float32
    assert got.item() == pytest.approx(want, rel=RTOL)


def test_rw_penalty_matches_jax():
    params, fisher, scores, anchor = _rand(0), _rand(1, True), _rand(2, True), _rand(3)
    want = float(jcl.rw_penalty(_j(params), _j(fisher), _j(scores), _j(anchor), 0.4))
    got = pcl.rw_penalty(_t(params), _t(fisher), _t(scores), _t(anchor), 0.4)
    assert got.item() == pytest.approx(want, rel=RTOL)


def test_rw_online_update_and_normalize_match_jax():
    fisher, scores, grads = _rand(1, True), _rand(2, True), _rand(3, scale=5.0)
    prev, curr = _rand(4), _rand(5)
    jf, js = jcl.rw_online_update(_j(fisher), _j(scores), _j(grads), _j(prev), _j(curr),
                                  jnp.asarray(1.5), jnp.asarray(1.2), alpha=0.9)
    pf, ps = pcl.rw_online_update(_t(fisher), _t(scores), _t(grads), _t(prev), _t(curr),
                                  torch.tensor(1.5), torch.tensor(1.2), alpha=0.9)
    for k in SHAPES:
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]), rtol=RTOL)
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), rtol=RTOL)
    jn, pn = jcl.normalize_scores(js), pcl.normalize_scores(ps)
    for k in SHAPES:
        np.testing.assert_allclose(pn[k].numpy(), np.asarray(jn[k]), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("use_half", [True, False])
def test_foreach_penalty_gives_the_plain_value_and_autograds_gradient(mask, use_half):
    """Two anchors (bf16, as EWC keeps them); the gradient lands in
    ``.grad`` on top of what the backward left there."""
    m = MASKS[mask]
    anchors = [{"weight": {k: v.to(torch.bfloat16) for k, v in _t(_rand(10 + i, True)).items()},
                "params": {k: v.to(torch.bfloat16) for k, v in _t(_rand(20 + i)).items()}}
               for i in range(2)]
    named = {k: torch.nn.Parameter(v) for k, v in _t(_rand(0)).items()}
    base = {k: torch.from_numpy(v) for k, v in _rand(7).items()}
    for k, p in named.items():
        p.grad = base[k].clone()
    pen = pcl.QuadraticPenalty(named, anchors, 0.4, m, use_half=use_half, name="x")
    value, aux = pen()
    pen.add_grad()
    ref = {k: v.detach().clone().requires_grad_() for k, v in named.items()}
    want = pcl.quadratic_penalty(ref, anchors, 0.4, m, use_half=use_half)
    want.backward()
    assert not value.requires_grad and aux == {"x": value}
    assert value.item() == pytest.approx(want.item(), rel=RTOL)
    for k, p in named.items():
        grad = ref[k].grad if ref[k].grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(p.grad, base[k] + grad, rtol=RTOL, atol=1e-7)


# ------------------------------------------------------------ the masked optimizer
FROZEN = {"enc0.w": False, "enc0.b": True, "vit.norm.w": False, "seg0.w": True}


@pytest.mark.parametrize("mask", ["some_frozen", "all_frozen", "none_frozen"])
def test_masked_poly_sgd_equals_optax_masked_chain(mask):
    """3 steps of gradients large enough that the clip (global norm 12
    over the trainable leaves) acts on every one."""
    trainable = {"some_frozen": FROZEN, "all_frozen": dict.fromkeys(SHAPES, False),
                 "none_frozen": dict.fromkeys(SHAPES, True)}[mask]
    init = _rand(0)
    named = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = PolySGD(list(named.items()), max_epochs=4, iters_per_epoch=2,
                  trainable_mask=trainable)
    tx = make_optimizer(max_epochs=4, iters_per_epoch=2, trainable_mask=trainable)
    jparams = _j(init)
    state = tx.init(jparams)
    for step in range(3):
        grads = _rand(100 + step, scale=20.0)
        live = [grads[k] for k in SHAPES if trainable[k]]
        assert not live or np.sqrt(sum((g ** 2).sum() for g in live)) > 12
        updates, state = tx.update(_j(grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
    for k, p in named.items():
        if trainable[k]:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(p.detach(), torch.from_numpy(init[k])), k
            assert np.array_equal(np.asarray(jparams[k]), init[k]), k
    # the state round-trips under the mask: one more step from a copy
    twin = {k: torch.nn.Parameter(p.detach().clone()) for k, p in named.items()}
    opt2 = PolySGD(list(twin.items()), max_epochs=4, iters_per_epoch=2,
                   trainable_mask=trainable)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.step_count == 3
    grads = _rand(200, scale=20.0)
    for o, params in ((opt, named), (opt2, twin)):
        o.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        o.step()
    for k in SHAPES:
        assert torch.equal(named[k], twin[k]), k


def test_a_mask_needs_parameter_names():
    with pytest.raises(ValueError):
        PolySGD([torch.nn.Parameter(torch.ones(2))], 4, 2, trainable_mask={"a": False})


# ------------------------------------------------------------ the converter
POOLS = ((2, 2, 2), (2, 2, 2))
CONVS = ((3, 3, 3),) * 3


@pytest.fixture(scope="module")
def unet_params():
    jmodel = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                     base_num_features=4, max_num_features=16)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))["params"])
    return params, GenericUNet(1, 3, POOLS, CONVS, 4, 16)


def _like(flat, seed, positive=False, dtype=np.float32):
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        r = rng.standard_normal(np.shape(v)).astype(np.float32)
        out[k] = (np.abs(r) if positive else r).astype(dtype)
    return out


def test_converted_ewc_state_gives_the_jax_penalty(unet_params):
    """Fisher and anchors in bf16 over every tensor (EWC) and over the
    norms only (a name-filtered variant), on perturbed parameters."""
    params, model = unet_params
    flat = jmh.flatten(params)
    norms = {k: v for k, v in flat.items() if "norm" in k.lower()}
    state = {"ewc_tasks": {
        "A": {"fisher": _like(flat, 1, True, ml_dtypes.bfloat16),
              "params": _like(flat, 2, dtype=ml_dtypes.bfloat16)},
        "B": {"fisher": _like(norms, 3, True, ml_dtypes.bfloat16),
              "params": _like(norms, 4, dtype=ml_dtypes.bfloat16)}}}
    moved = jmh.unflatten(_like(flat, 5))
    got_state = jax_cl_state_to_torch(state, params, model)
    assert sorted(got_state["ewc_tasks"]["B"]["fisher"]) == sorted(
        k for k in model.state_dict() if "norm" in k)
    assert all(v.dtype == torch.bfloat16 for t in got_state["ewc_tasks"].values()
               for part in t.values() for v in part.values())
    sd = jax_params_to_state_dict(moved, model)
    for tasks in (["A"], ["B"], ["A", "B"]):
        want = float(jcl.ewc_penalty(jmh.flatten(moved),
                                     {t: state["ewc_tasks"][t] for t in tasks}, 0.4))
        got = pcl.ewc_penalty(sd, {t: got_state["ewc_tasks"][t] for t in tasks}, 0.4)
        assert got.item() == pytest.approx(want, rel=1e-5), tasks


def test_converted_rw_state_gives_the_jax_penalty(unet_params):
    params, model = unet_params
    flat = jmh.flatten(params)
    state = {"running": {"fisher": _like(flat, 1, True), "scores": _like(flat, 2, True),
                         "prev_params": _like(flat, 3), "prev_loss": np.float32(1.25),
                         "iter": np.int32(7)},
             "anchor": {"fisher": _like(flat, 4, True), "scores": _like(flat, 5, True),
                        "params": _like(flat, 6)},
             "score_sets": [_like(flat, 7, True, ml_dtypes.bfloat16)], "num_tasks_done": 1}
    got = jax_cl_state_to_torch(state, params, model)
    assert got["running"]["iter"] == 7 and got["num_tasks_done"] == 1
    assert got["running"]["prev_loss"].item() == 1.25
    assert all(v.dtype == torch.bfloat16 for v in got["score_sets"][0].values())
    moved = jmh.unflatten(_like(flat, 8))
    a = state["anchor"]
    want = float(jcl.rw_penalty(jmh.flatten(moved), a["fisher"], a["scores"], a["params"],
                                0.4))
    ga = got["anchor"]
    val = pcl.rw_penalty(jax_params_to_state_dict(moved, model), ga["fisher"], ga["scores"],
                         ga["params"], 0.4)
    assert val.item() == pytest.approx(want, rel=1e-5)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_half", [True, False])
def test_foreach_penalty_on_the_card_matches_the_cpu(cuda_device, use_half):
    """The same penalty, value and gradient, on the card and on the CPU,
    at U-Net-like sizes (two bf16 anchors)."""
    rng = np.random.RandomState(0)
    shapes = [(64, 32, 3, 3, 3), (64,), (320, 320, 3, 3, 3), (3, 32, 1, 1, 1)]
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}
    anchors = [{"weight": {k: torch.from_numpy(np.abs(rng.standard_normal(v.shape))
                                                .astype(np.float32)).to(torch.bfloat16)
                           for k, v in params.items()},
                "params": {k: torch.from_numpy(rng.standard_normal(v.shape)
                                               .astype(np.float32)).to(torch.bfloat16)
                           for k, v in params.items()}} for _ in range(2)]
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        named = {k: torch.nn.Parameter(torch.from_numpy(v).to(dev)) for k, v in params.items()}
        on = [{part: {k: t.to(dev) for k, t in a[part].items()} for part in a}
              for a in anchors]
        pen = pcl.QuadraticPenalty(named, on, 0.4, use_half=use_half)
        value, _ = pen()
        pen.add_grad()
        out[dev.type] = (value.cpu(), {k: p.grad.cpu() for k, p in named.items()})
    assert out["cuda"][0].item() == pytest.approx(out["cpu"][0].item(), rel=1e-5)
    for k in params:
        torch.testing.assert_close(out["cuda"][1][k], out["cpu"][1][k], rtol=1e-6, atol=1e-6)
