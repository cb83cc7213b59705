"""The port's attention (lifelong_nnunet_tpu_torch/ops/kernels/attention.py)
against the JAX package's.

* ``plain_attention`` (autograd) and the ``flash_attention`` wrapper (its
  ``autograd.Function`` with the plain forward and FlashAttention-2
  backward on the CPU) against jax's Pallas TPU flash attention, as
  ``models/vit.py::_flash_attention`` calls it, run in interpret mode on the
  CPU: the output and the gradients of q, k and v, in f32, at the token
  counts the TPU kernel takes (256, 512) and both head dims (64, 80).
* At a ragged token count (70, which no tile divides), the port's
  ``Attention`` module on both routes against the JAX ``Attention``'s
  einsum path, with and without LSA: output, weights, input gradient.
* The wrapper's choice of kernel, on meta tensors with a stand-in
  extension: bf16 to the tensor-core entries, f32 to the FMA entries, each
  launch counted (``tc_launches`` for bf16 only), a head dim or dtype the
  kernels do not take refused before any launch.
* The CUDA kernels against the plain versions on the card (marked
  ``cuda``, skipped without one; chip_smoke.py runs them at full size):
  both dtypes at the train step's shape, and the tensor-core kernels at
  ragged token counts and both head dims, a second run equal bit for bit.

Inputs are numpy-seeded; each tolerance is stated where it is used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu_torch.models.vit import Attention
from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd, flash_attention_fwd, plain_attention,
    plain_attention_bwd, plain_attention_fwd)

torch.set_num_threads(2)

SHAPES = [(256, 64), (512, 64), (256, 80), (512, 80)]
_JAX = {}


def _inputs(n, hd, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(1, 2, n, hd)).astype(np.float32) for _ in range(4)]


def _jax_vit():
    """The JAX package's ViT module, imported by the tests that compare with
    it: it needs flax, which a host that runs only the CUDA-marked tests
    may lack."""
    from lifelong_nnunet_tpu.models import vit
    return vit


def _jax_flash(n, hd):
    """(q, k, v, g, out, dq, dk, dv) of jax's TPU flash attention in
    interpret mode, the gradients of sum(out * g); computed once per shape."""
    from jax.experimental.pallas import tpu as pltpu
    if (n, hd) not in _JAX:
        q, k, v, g = _inputs(n, hd)
        scale = hd ** -0.5
        flash = _jax_vit()._flash_attention
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda q_, k_, v_: flash(q_, k_, v_, scale),
                               jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            grads = vjp(jnp.asarray(g))
        _JAX[(n, hd)] = [q, k, v, g, np.asarray(out)] + [np.asarray(t) for t in grads]
    return _JAX[(n, hd)]


def _port(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("route", ["plain_attention", "flash_attention"])
@pytest.mark.parametrize("n,hd", SHAPES, ids=[f"N{n}-hd{hd}" for n, hd in SHAPES])
def test_matches_jax_flash_attention(n, hd, route):
    """Output and the three gradients to 2e-5 + 1e-4 relative, f32 (sums
    in another order than the TPU kernel's blocks)."""
    q, k, v, g, *want = _jax_flash(n, hd)
    fn = (lambda *t: plain_attention(*t)[0]) if route == "plain_attention" \
        else flash_attention
    for name, got, ref in zip(("out", "dq", "dk", "dv"), _port(fn, q, k, v, g), want):
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4, err_msg=name)


def test_flash_backward_is_the_plain_backward_on_the_cpu():
    """The wrapper's backward on a CPU tensor is the plain FlashAttention-2
    recomputation, and it equals autograd of the plain attention to 1e-5."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(70, 64, seed=1))
    out = plain_attention(q, k, v)[0]
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k) * 64 ** -0.5
    lse = torch.logsumexp(logits, dim=-1)
    got = flash_attention_bwd(q, k, v, out, lse, g)
    want = plain_attention_bwd(q, k, v, out, lse, g)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_attention(*ts)[0].backward(g)
    for a, b, t in zip(got, want, ts):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, t.grad, atol=1e-5, rtol=1e-5)


def test_forward_keeps_the_row_log_sum_exp():
    """On a CPU tensor ``flash_attention_fwd`` is ``plain_attention_fwd``:
    the output of ``plain_attention`` and the f32 log-sum-exp of the scaled
    logits, at a ragged N = 70, hd 80, f32, to 1e-6."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(70, 80, seed=2))
    out, lse = flash_attention_fwd(q, k, v)
    want = plain_attention_fwd(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip((out, lse), want))
    torch.testing.assert_close(out, plain_attention(q, k, v)[0], atol=1e-6, rtol=1e-6)
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k) * 80 ** -0.5
    assert lse.shape == (1, 2, 70) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-6, rtol=1e-6)


def _jax_attention(lsa, x):
    jm = _jax_vit().Attention(num_heads=2, lsa=lsa)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    return jm, params


def _port_attention(params, lsa, use_kernels):
    m = Attention(32, 2, lsa, use_kernels, torch.Generator().manual_seed(0))
    sd = {f"{name}.{t}": torch.tensor(
        params[name]["kernel"].T if t == "weight" else params[name]["bias"])
        for name in ("qkv", "proj") for t in ("weight", "bias")}
    if lsa:
        sd["temperature"] = torch.tensor(params["temperature"])
    m.load_state_dict(sd)
    return m


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain_route"])
@pytest.mark.parametrize("lsa", [False, True], ids=["no_lsa", "lsa"])
def test_attention_module_at_a_ragged_token_count(lsa, use_kernels):
    """N = 70, D = 32, 2 heads, f32: output and input gradient to 1e-5 +
    1e-4 relative, the weights (asked for) to 1e-6.  Without LSA and
    without weights the kernel route runs ``flash_attention``."""
    rng = np.random.RandomState(2)
    x, g = (rng.normal(size=(2, 70, 32)).astype(np.float32) for _ in range(2))
    jm, params = _jax_attention(lsa, x)
    j_out, vjp = jax.vjp(lambda x_: jm.apply({"params": params}, x_, need_weights=False)[0],
                         jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(g))
    _, j_w = jm.apply({"params": params}, jnp.asarray(x), need_weights=True)
    m = _port_attention(params, lsa, use_kernels)
    xt = torch.from_numpy(x).requires_grad_()
    before = flash_attention.launches
    out, w = m(xt, torch.float32, need_weights=False)
    assert w is None or not use_kernels or lsa
    out.backward(torch.from_numpy(g))
    assert flash_attention.launches == before          # the CPU launches nothing
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        _, w = m(torch.from_numpy(x), torch.float32, need_weights=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), atol=1e-6)
    if lsa:
        assert float(w[..., range(70), range(70)].max()) == 0.0   # no self-attention


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On a non-CPU device the wrapper launches the kernel or raises; it
    never falls back to the plain version."""
    q = torch.zeros(1, 2, 8, 48, device="meta")
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, q, q)


class _Entries:
    """A stand-in for the built extension: records which attention entry
    each launch called."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.startswith("flash_attention"):
            raise AttributeError(name)
        return lambda *args: self.called.append(name)


@pytest.fixture()
def entries(monkeypatch):
    ext = _Entries()
    monkeypatch.setattr(build, "require_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(build, "load_extension", lambda: ext)
    return ext


def _meta(dtype, hd=64):
    return [torch.zeros(1, 2, 70, hd, dtype=dtype, device="meta") for _ in range(4)]


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True), (torch.float32, False)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_dtype_chooses_the_kernel(entries, dtype, tc, direction):
    """bf16 launches the tensor-core entry and counts on ``tc_launches``;
    f32 launches the FMA entry and counts on ``launches`` alone."""
    q, k, v, g = _meta(dtype)
    wrapper = flash_attention if direction == "fwd" else flash_attention_bwd
    before = (wrapper.launches, wrapper.tc_launches)
    if direction == "fwd":
        out, lse = flash_attention_fwd(q, k, v)
        assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (1, 2, 70)
    else:
        grads = flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 70, device="meta"), g)
        assert [t.dtype for t in grads] == [dtype] * 3
    assert entries.called == [f"flash_attention_{'tc_' if tc else ''}{direction}"]
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 1, before[1] + tc)


@pytest.mark.parametrize("dtype,hd,error", [
    (torch.bfloat16, 48, ValueError), (torch.float32, 96, ValueError),
    (torch.float16, 64, TypeError)], ids=["bf16-hd48", "f32-hd96", "f16"])
def test_wrapper_refuses_before_any_launch(entries, dtype, hd, error):
    """A head dim outside HEAD_DIMS, or a dtype other than f32 / bf16,
    raises on either entry before the extension is called."""
    q, k, v, g = _meta(dtype, hd)
    counts = [(f.launches, f.tc_launches) for f in (flash_attention, flash_attention_bwd)]
    with pytest.raises(error):
        flash_attention_fwd(q, k, v)
    with pytest.raises(error):
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 2, 70, device="meta"), g)
    assert entries.called == []
    assert [(f.launches, f.tc_launches) for f in (flash_attention, flash_attention_bwd)] \
        == counts


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_on_cuda(cuda_device, dtype, atol):
    """Forward and backward kernels against the plain versions on the card,
    at the train step's (1, 12, 490, 64) and hd 80: atol 1e-4 f32 /
    3e-2 bf16, rtol 1e-2."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in [(1, 12, 490, 64), (1, 4, 70, 80)]:
        q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
                      for _ in range(4))
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*ts)
        out.backward(g)
        ref = [t.clone().float().requires_grad_() for t in (q, k, v)]
        ref_out = plain_attention(*ref)[0]
        ref_out.backward(g.float())
        torch.cuda.synchronize()
        for a, b in zip([out] + [t.grad for t in ts], [ref_out] + [t.grad for t in ref]):
            torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("n", [70, 257, 490])
def test_tensor_core_kernels_match_plain_on_cuda(cuda_device, n, hd):
    """bf16 on the tensor-core kernels: out and the row log-sum-exp, then
    dq, dk, dv from the plain forward's out and lse, against the plain
    versions at ragged token counts (atol 3e-2 + rtol 1e-2; the lse to
    1e-4 + 1e-5); a second run equal bit for bit; each launch counted on
    ``tc_launches``, and an f32 launch on the FMA kernel only."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + hd)
    q, k, v, g = (torch.randn((2, 3, n, hd), generator=gen, device=cuda_device)
                  .to(torch.bfloat16) for _ in range(4))
    counts = [(f.launches, f.tc_launches) for f in (flash_attention, flash_attention_bwd)]
    out, lse = flash_attention_fwd(q, k, v)
    ref, ref_lse = plain_attention_fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, ref, ref_lse, g)
    want = plain_attention_bwd(q, k, v, ref, ref_lse, g)
    again = (*flash_attention_fwd(q, k, v), *flash_attention_bwd(q, k, v, ref, ref_lse, g))
    flash_attention_fwd(*(t.float() for t in (q, k, v)))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    for a, b in zip((out, *grads), (ref, *want)):
        torch.testing.assert_close(a.float(), b.float(), atol=3e-2, rtol=1e-2)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, lse, *grads)))
    assert [(f.launches, f.tc_launches) for f in (flash_attention, flash_attention_bwd)] == [
        (counts[0][0] + 3, counts[0][1] + 2), (counts[1][0] + 2, counts[1][1] + 2)]
