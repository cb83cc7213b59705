"""The port's POD and PLOP losses (``lifelong_nnunet_tpu_torch/ops/cl_losses.py``)
against the JAX package's on the CPU: seeded numpy inputs, the JAX ones
channels-last, the port's channels-first; values and gradients to 1e-5.

Each is also held to the formula the reference's own test cites
(``tests/test_reference_parity.py:322-401``), written out here in numpy,
since that test needs the absent reference and the JAX output is no ground
truth on its own.  Where the JAX POD is NaN (the gradient at a zero norm,
and a region left empty on a non-square map) the port departs from it, and
two tests pin both sides, so that a later repair of the JAX package shows.

``jax_pod_distance_repaired`` is the JAX POD distance with those two
repairs, in JAX: the trainer tests (``test_torch_cl_pod_trainers.py``)
patch it into the JAX package's module for the run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu_torch.ops import cl_losses as pcl

TOL = 1e-5


def _cf(x: np.ndarray) -> torch.Tensor:
    """A channels-last array as the port's channels-first tensor."""
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------ the JAX POD, repaired
def _jax_blocks_repaired(act, scales):
    """The JAX ``_pod_blocks`` loop with the regions whose slice is empty
    on either pooled axis left out."""
    W, H = act.shape[-2], act.shape[-3]
    actf = act.astype(jnp.float32)
    wvecs, hvecs = [], []
    for scale in range(scales):
        w, h = int(W / (2 ** scale)), int(H / (2 ** scale))
        for i in range(0, W - w, w):
            for j in range(0, H - h, h):
                if i >= H or j >= W:
                    continue
                sl = actf[..., i:i + w, j:j + h, :]
                wvecs.append(jnp.mean(sl, axis=-2))
                hvecs.append(jnp.mean(sl, axis=-3))
    if not wvecs:
        return None, None
    return jnp.concatenate(wvecs, axis=-2), jnp.concatenate(hvecs, axis=-2)


def _safe_norm(d):
    """L2 norm over axis -2 with a zero gradient at a zero norm."""
    s = jnp.sum(d * d, axis=-2)
    pos = s > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)


def jax_pod_distance_repaired(act, teacher_act, scales: int = 3):
    """The JAX ``local_pod_distance`` with the port's two departures."""
    pw, ph = _jax_blocks_repaired(act, scales)
    ow, oh = _jax_blocks_repaired(teacher_act, scales)
    if pw is None:
        return jnp.asarray(0.0)
    return (jnp.mean(_safe_norm(pw - ow)) + jnp.mean(_safe_norm(ph - oh))) / 2.0


# ------------------------------------------------ the reference's formulas
def _ref_regions(a: np.ndarray, scales: int):
    """The reference's region loop on a channels-first array: (width-pooled,
    height-pooled) row blocks, regions empty on either axis left out."""
    H, W = a.shape[-2], a.shape[-1]
    wv, hv = [], []
    for scale in range(scales):
        w, h = int(W / 2 ** scale), int(H / 2 ** scale)
        for i in range(0, W - w, w):
            for j in range(0, H - h, h):
                sl = a[..., i:i + w, j:j + h]
                if sl.shape[-2] and sl.shape[-1]:
                    wv.append(sl.mean(-1))
                    hv.append(sl.mean(-2))
    return wv, hv


def ref_local_pod(a: np.ndarray, b: np.ndarray, scales: int) -> float:
    """``local_POD`` of the reference (embeddings.py:9-42) in f64 on
    channels-first arrays: on a square map each region's ``pod_embed``
    (the two pooled means concatenated over channels), the regions
    concatenated along the last axis, the L2 norm per row, the mean; on a
    non-square map the two pooled blocks apart, each row's norm the same."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    (wa, ha), (wb, hb) = _ref_regions(a, scales), _ref_regions(b, scales)
    if not wa:
        return 0.0
    if a.shape[-1] == a.shape[-2]:
        ea = np.concatenate([np.concatenate([x, y], axis=1) for x, y in zip(wa, ha)], -1)
        eb = np.concatenate([np.concatenate([x, y], axis=1) for x, y in zip(wb, hb)], -1)
        return float(np.linalg.norm(ea - eb, axis=-1).mean())
    dw = np.linalg.norm(np.concatenate(wa, -1) - np.concatenate(wb, -1), axis=-1)
    dh = np.linalg.norm(np.concatenate(ha, -1) - np.concatenate(hb, -1), axis=-1)
    return float((dw.mean() + dh.mean()) / 2)


def _softmax(x, axis=1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def ref_confidence(logits: np.ndarray) -> np.ndarray:
    """The reference's entropy (crossentropy.py:6-16, a channel mean) over
    log(C) (plop/...:124), channels-first, f64."""
    p = _softmax(logits.astype(np.float64))
    c = p.shape[1]
    ent = -(1 / np.log(c + 1e-8)) * (p * np.log(p + 1e-8)).mean(axis=1)
    return ent / np.log(c)


def ref_pseudo_label_loss(logits, teacher, target, thresholds) -> float:
    """``_pseudo_label_loss`` (deep_supervision.py:287-332) in numpy:
    torch's mean CE with ignore_index -1 (0 when all ignored) on the
    confident background (teacher labels) and on the rest (true labels),
    times the batch mean of |B & V| / |B| per item."""
    conf = ref_confidence(teacher)
    pseudo = teacher.argmax(1)
    pv = (target == 0) & (conf < thresholds[pseudo])
    logp = np.log(_softmax(logits.astype(np.float64)))

    def ce(lab):
        valid = lab >= 0
        if not valid.any():
            return 0.0
        picked = np.take_along_axis(logp, np.where(valid, lab, 0)[:, None], 1)[:, 0]
        return float(-picked[valid].mean())

    axes = tuple(range(1, target.ndim))
    factor = (pv.sum(axes) / np.maximum((target == 0).sum(axes), 1)).mean()
    return float(factor * (ce(np.where(pv, pseudo, -1)) + ce(np.where(pv, -1, target))))


# ---------------------------------------------------------------- POD
POD_CASES = {  # id: (channels-last tap shape, scales)
    "square2d": ((2, 8, 8, 4), 3),
    "square2d_16": ((1, 16, 16, 2), 3),
    "lead_square": ((2, 4, 8, 8, 2), 2),
    "enc0_80x56": ((1, 2, 80, 56, 3), 3),     # clamped W[40:60] at scale 2
    "dec_14x20": ((2, 3, 20, 14, 2), 3),
    "no_region": ((2, 6, 6, 3), 1),
}


@pytest.mark.parametrize("shape,scales", list(POD_CASES.values()), ids=list(POD_CASES))
def test_local_pod_distance_is_jax(shape, scales):
    """Where JAX is finite and the taps differ, the port gives its value and
    gradient, and the reference formula's value."""
    rng = np.random.default_rng(sum(shape) + scales)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    want, jgrad = jax.value_and_grad(jcl.local_pod_distance)(jnp.asarray(a), jnp.asarray(b),
                                                             scales)
    assert np.isfinite(float(want))
    x = _cf(a).requires_grad_(True)
    got = pcl.local_pod_distance(x, _cf(b), scales)
    if scales == 1:
        assert float(got) == float(want) == 0.0
        return
    got.backward()
    _close(got.item(), float(want), "value")
    _close(np.moveaxis(x.grad.numpy(), 1, -1), jgrad, "gradient")
    _close(got.item(), ref_local_pod(np.moveaxis(a, -1, 1), np.moveaxis(b, -1, 1), scales),
           "reference formula")


@pytest.mark.parametrize("hw", [(5, 7), (7, 5)], ids=["H5W7", "H7W5"])
def test_pod_leaves_out_empty_regions(hw):
    """The hippocampus plan's bottleneck tap (D7 x H5 x W7) and its
    transpose: the JAX region loop runs past the shorter axis and takes the
    mean of an empty slice (NaN); the port leaves those regions out and
    gives the formula's finite value."""
    rng = np.random.default_rng(hw[0])
    shape = (2, 7) + hw + (4,)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    assert np.isnan(float(jcl.local_pod_distance(jnp.asarray(a), jnp.asarray(b), 3)))
    assert np.isnan(float(jcl.local_pod_loss({"bottleneck": jnp.asarray(a)},
                                             {"bottleneck": jnp.asarray(b)})))
    got = float(pcl.local_pod_distance(_cf(a), _cf(b), 3))
    assert np.isfinite(got)
    _close(got, ref_local_pod(np.moveaxis(a, -1, 1), np.moveaxis(b, -1, 1), 3), "formula")
    _close(got, float(jax_pod_distance_repaired(jnp.asarray(a), jnp.asarray(b), 3)),
           "repaired JAX")


def test_pod_gradient_is_finite_where_student_equals_teacher():
    """The first step of every new task: the student's taps equal the
    teacher's.  The JAX gradient of sqrt at 0 is NaN; the port's (the
    reference's torch.norm) is 0."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 4, 8, 8, 3)).astype(np.float32)
    jgrad = jax.grad(jcl.local_pod_distance)(jnp.asarray(a), jnp.asarray(a), 3)
    assert np.isnan(np.asarray(jgrad)).any()
    x = _cf(a).requires_grad_(True)
    value = pcl.local_pod_distance(x, _cf(a), 3)
    value.backward()
    assert float(value) == 0.0
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) == 0.0
    rgrad = jax.grad(jax_pod_distance_repaired)(jnp.asarray(a), jnp.asarray(a), 3)
    assert float(jnp.abs(rgrad).max()) == 0.0


def _taps(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_local_pod_loss_is_jax_with_the_running_division():
    """Over a dict of U-Net-like taps (sorted keys, non-square, scales
    clamped by the smaller pooled axis), value and every tap's gradient;
    and the reference's composition: per layer add pod_lambda x local_POD
    and divide the running total by the layer count."""
    rng = np.random.default_rng(7)
    shapes = {"enc0": (2, 4, 16, 12, 2), "enc1": (2, 2, 8, 6, 4), "dec0": (2, 2, 8, 6, 4),
              "dec1": (2, 4, 16, 12, 2), "bottleneck": (2, 1, 2, 3, 8)}
    s, t = _taps(rng, shapes), _taps(rng, shapes)
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    want, jgrad = jax.value_and_grad(
        lambda taps: jcl.local_pod_loss(taps, jt, 3, 1e-2))({k: jnp.asarray(v)
                                                            for k, v in s.items()})
    ps = {k: _cf(v).requires_grad_(True) for k, v in s.items()}
    got = pcl.local_pod_loss(ps, {k: _cf(v) for k, v in t.items()}, 3, 1e-2)
    got.backward()
    _close(float(got), float(want), "value")
    for k in shapes:
        _close(np.moveaxis(ps[k].grad.numpy(), 1, -1), jgrad[k], k)
    total = 0.0
    for k in sorted(shapes):
        a = np.moveaxis(s[k], -1, 1)
        eff = max(1, min(3, min(a.shape[-2:]).bit_length()))
        total = (total + 1e-2 * ref_local_pod(a, np.moveaxis(t[k], -1, 1), eff)) / len(shapes)
    _close(float(got), total, "reference composition")
    assert float(pcl.local_pod_loss({"a": ps["enc0"]}, {"b": ps["enc0"]})) == 0.0


def test_pod_embed_and_embedding_are_jax():
    rng = np.random.default_rng(5)
    sq = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    got = pcl.pod_embed(_cf(sq))                                  # [B, 2C, D, h]
    want = np.asarray(jcl.pod_embed(jnp.asarray(sq)))             # [B, D, h, 2C]
    _close(got.numpy(), np.moveaxis(want, -1, 1), "pod_embed")
    for scales in (1, 2, 3):
        # the same rows, flattened in each package's layout
        got = pcl.pod_embedding(_cf(sq), scales).numpy()
        want = np.asarray(jcl.pod_embedding(jnp.asarray(sq), scales))
        assert got.shape == want.shape
        _close(np.sort(got, axis=1), np.sort(want, axis=1), f"pod_embedding {scales}")
    pw, ph = pcl._pod_blocks(_cf(sq), 3)
    jw, jh = jcl._pod_blocks(jnp.asarray(sq), 3)
    _close(pw.numpy(), np.moveaxis(np.asarray(jw), -1, 1), "width block")
    _close(ph.numpy(), np.moveaxis(np.asarray(jh), -1, 1), "height block")


# ---------------------------------------------------------------- PLOP
def _logits(rng, shape, classes, scale=2.0):
    x = (rng.normal(size=shape + (classes,)) * scale).astype(np.float32)
    return x, _cf(x)


def test_entropy_and_confidence_are_jax():
    rng = np.random.default_rng(8)
    x, xt = _logits(rng, (2, 7, 7), 5)
    p = jax.nn.softmax(jnp.asarray(x), -1)
    pt = torch.softmax(xt, 1)
    _close(pcl.entropy(pt).numpy(), np.asarray(jcl.entropy(p)), "entropy")
    _close(pcl.entropy_confidence(pt).numpy(), np.asarray(jcl.entropy_confidence(p)),
           "confidence")
    _close(pcl.entropy_confidence(pt).numpy(), ref_confidence(np.moveaxis(x, -1, 1)),
           "reference formula")


def _plop_inputs(seed, shape=(2, 6, 8, 8), classes=3):
    rng = np.random.default_rng(seed)
    x, xt = _logits(rng, shape, classes)
    t, tt = _logits(rng, shape, classes)
    target = rng.integers(0, classes, shape).astype(np.int64)
    return x, xt, t, tt, target


def test_plop_pseudo_label_loss_is_jax():
    """Thresholds that make both masks non-trivial: value and gradient."""
    x, xt, t, tt, target = _plop_inputs(12)
    thr = np.asarray([0.3, 0.5, 0.7], np.float32)
    conf = ref_confidence(np.moveaxis(t, -1, 1))
    pv = (target == 0) & (conf < thr[np.moveaxis(t, -1, 1).argmax(1)])
    assert 0 < pv.sum() < (target == 0).sum()
    want, jgrad = jax.value_and_grad(jcl.plop_pseudo_label_loss)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(target.astype(np.int32)),
        jnp.asarray(thr))
    xt.requires_grad_(True)
    got = pcl.plop_pseudo_label_loss(xt, tt, torch.from_numpy(target), torch.from_numpy(thr))
    got.backward()
    _close(float(got), float(want), "value")
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), jgrad, "gradient")
    _close(float(got), ref_pseudo_label_loss(np.moveaxis(x, -1, 1), np.moveaxis(t, -1, 1),
                                             target, thr), "reference formula")
    pseudo, share = pcl.plop_pseudo_targets(torch.from_numpy(target), tt,
                                            torch.from_numpy(thr), 3)
    jpseudo, jshare = jcl.plop_pseudo_targets(jnp.asarray(target.astype(np.int32)),
                                              jnp.asarray(t), jnp.asarray(thr), 3)
    assert np.array_equal(pseudo.numpy(), np.asarray(jpseudo))
    _close(float(share), float(jshare), "confident share")


def test_plop_loss_where_every_voxel_is_ignored():
    """No confident background voxel: the pseudo CE sees every voxel
    ignored.  F.cross_entropy's mean is NaN there; the JAX ``_ce_mean`` and
    the port's give 0, and so does the whole loss when there is no
    background at all."""
    x, xt, t, tt, target = _plop_inputs(13)
    ignored = torch.full(tuple(target.shape), -1)
    assert torch.isnan(F.cross_entropy(xt, ignored, ignore_index=-1))
    assert float(pcl._ce_mean(xt, ignored)) == 0.0
    assert float(jcl._ce_mean(jnp.asarray(x), jnp.asarray(np.full(target.shape, -1)))) == 0.0
    none = np.zeros(3, np.float32)          # no voxel is below a 0 threshold
    fg = np.where(target == 0, 1, target)   # no background
    for thr, tgt in ((none, target), (np.ones(3, np.float32), fg)):
        want = float(jcl.plop_pseudo_label_loss(jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(tgt.astype(np.int32)),
                                                jnp.asarray(thr)))
        got = float(pcl.plop_pseudo_label_loss(xt, tt, torch.from_numpy(tgt),
                                               torch.from_numpy(thr)))
        assert got == want == 0.0


@pytest.mark.parametrize("classes", [2, 3, 4])
def test_entropy_histogram_and_thresholds_are_jax_exactly(classes):
    """Two batches' histograms (background voxels only, the overflow row of
    ignored and foreground voxels dropped) and their medians, bit for bit;
    the median against a histogram median written out."""
    rng = np.random.default_rng(20 + classes)
    hist = torch.zeros(classes, 100)
    jhist = jnp.zeros((classes, 100), jnp.float32)
    for _ in range(2):
        t, tt = _logits(rng, (2, 6, 10, 6), classes, scale=1.5)
        target = rng.integers(-1, classes, (2, 6, 10, 6))
        hist = pcl.accumulate_entropy_histogram(hist, tt, torch.from_numpy(target), classes)
        jhist = jcl.accumulate_entropy_histogram(jhist, jnp.asarray(t),
                                                 jnp.asarray(target.astype(np.int32)),
                                                 classes)
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    assert hist.sum() > 0
    thr = pcl.median_entropy_thresholds(hist)
    assert np.array_equal(thr.numpy(), np.asarray(jcl.median_entropy_thresholds(jhist)))
    h = hist.numpy().astype(np.int64)
    for c in range(classes):
        cum = np.cumsum(h[c])
        median_bin = int(np.nonzero(cum >= cum[-1] / 2)[0][0])
        assert float(thr[c]) == max(np.float32((median_bin + 0.5) / 100), np.float32(0.001))


def test_histogram_counts_background_voxels_by_the_teachers_class():
    rng = np.random.default_rng(31)
    t, tt = _logits(rng, (1, 4, 4, 4), 3)
    target = rng.integers(0, 3, (1, 4, 4, 4))
    hist = pcl.accumulate_entropy_histogram(torch.zeros(3, 100), tt, torch.from_numpy(target),
                                            3)
    pred = np.moveaxis(t, -1, 1).argmax(1)
    bg = target == 0
    assert hist.sum().item() == bg.sum()
    assert hist.sum(1).numpy().tolist() == [float((pred[bg] == c).sum()) for c in range(3)]
    conf = ref_confidence(np.moveaxis(t, -1, 1))[bg]
    bins = np.clip((conf * 100).astype(np.int64), 0, 99)
    assert hist.sum(0).numpy().tolist() == np.bincount(bins, minlength=100).tolist()
