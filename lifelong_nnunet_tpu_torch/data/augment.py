"""Device-side data augmentation: the port of
``lifelong_nnunet_tpu/data/augment.py`` (nnU-Net's moreDA transforms of
``_augment_one``), batched over the samples and run on the batch's device
with an explicit ``torch.Generator``.

Two steps: :func:`draw_params` draws every per-sample parameter (the
draws and gates of ``_augment_one``: rotation p=0.2 +-30 deg, scaling
p=0.2 0.7-1.4, low resolution p=0.25 zoom 0.5-1, noise p=0.1, blur p=0.2
sigma 0.5-1, brightness p=0.15, contrast p=0.15, inverted gamma p=0.1,
gamma p=0.3, mirroring p=0.5 per axis, and with ``do_elastic`` the
elastic deformation p=0.2, 0-6 voxels), and :func:`apply_params` applies
them, deterministically, in ``_augment_one``'s order.  Tests hand
``apply_params`` the parameters the JAX package drew and compare outputs;
the generators differ, so the draws themselves are compared by their
rates.

The spatial transform (rotation, scaling, the low-resolution snap of the
output grid and the elastic displacement, one resample) uses
``_augment_one``'s gather semantics (``sample_linear`` /
``sample_nearest``): a coordinate outside [0, s-1] on any axis gives
``cval`` (data 0, seg -1), inside it the 8-corner trilinear (data) or
rounded nearest (seg) value.  The elastic displacement is a coarse
uniform field in [-1, 1) of ``max(2, s // elastic_grid)`` points per axis,
resized to the patch by :func:`resize_cubic` (``jax.image.resize``'s
cubic rule), times the drawn magnitude, added to the coordinates after
the snap and the affine map.  It is off by default, as in nnU-Net's
moreDA configuration, and no trainer turns it on: a caller sets
``do_elastic`` in the train step's ``AugmentConfig``.  The JAX package's
shear-decomposed matmul resampler (``spatial_mode``) exists only because
gathers are slow on a TPU and is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class AugmentConfig:
    do_rotation: bool = True
    p_rot: float = 0.2
    rot_max: float = math.radians(30.0)
    do_scaling: bool = True
    p_scale: float = 0.2
    scale_range: tuple = (0.7, 1.4)
    do_mirror: bool = True
    mirror_axes: tuple = (0, 1, 2)
    p_noise: float = 0.1
    p_blur: float = 0.2
    blur_sigma: tuple = (0.5, 1.0)
    p_brightness: float = 0.15
    p_contrast: float = 0.15
    p_lowres: float = 0.25
    p_gamma_inverted: float = 0.1
    p_gamma: float = 0.3
    gamma_range: tuple = (0.7, 1.5)
    # elastic deformation (off in nnU-Net's moreDA configuration)
    do_elastic: bool = False
    p_eldef: float = 0.2
    elastic_magnitude: tuple = (0.0, 6.0)   # voxels of largest displacement
    elastic_grid: int = 4                   # the coarse field's downscale factor
    # anisotropic volumes: rotate only in-plane (about the leading axis)
    dummy_2d: bool = False


NO_AUGMENT = AugmentConfig(do_rotation=False, do_scaling=False, do_mirror=False,
                           p_noise=0.0, p_blur=0.0, p_brightness=0.0, p_contrast=0.0,
                           p_lowres=0.0, p_gamma_inverted=0.0, p_gamma=0.0)


def draw_params(batch: int, dim: int, cfg: AugmentConfig,
                generator: torch.Generator, device: torch.device,
                patch: tuple | None = None) -> dict:
    """Every per-sample parameter of one batch, as tensors on ``device``
    with a leading batch axis; a transform whose gate is closed gets its
    identity value (angle 0, scale 1, zoom pitch 1, multiplier 1) or a
    False flag.  With ``cfg.do_elastic`` (which needs ``patch``) the
    elastic magnitude, its gate and the coarse field ``[B, dim, *coarse]``
    are drawn after all the others, so the other draws do not depend on
    it."""

    def u(lo=0.0, hi=1.0, *shape):
        r = torch.rand((batch,) + shape, generator=generator, device=device)
        return lo + (hi - lo) * r

    def gate(p):
        return u() < p

    n_ang = 3 if dim == 3 else 1
    angles = u(-cfg.rot_max, cfg.rot_max, n_ang)
    if dim == 3 and cfg.dummy_2d:
        angles[:, 1:] = 0.0
    angles = torch.where(gate(cfg.p_rot)[:, None], angles, 0.0) if cfg.do_rotation \
        else torch.zeros_like(angles)
    scale = torch.where(gate(cfg.p_scale), u(*cfg.scale_range), 1.0) if cfg.do_scaling \
        else torch.ones(batch, device=device)
    p = {"angles": angles, "scale": scale,
         "lowres": torch.where(gate(cfg.p_lowres), u(1.0, 2.0), 1.0)}
    for name, prob, lo, hi in (("noise", cfg.p_noise, 0.0, 0.1),
                               ("blur", cfg.p_blur) + tuple(cfg.blur_sigma),
                               ("brightness", cfg.p_brightness, 0.75, 1.25),
                               ("contrast", cfg.p_contrast, 0.75, 1.25),
                               ("gamma_inverted", cfg.p_gamma_inverted)
                               + tuple(cfg.gamma_range),
                               ("gamma", cfg.p_gamma) + tuple(cfg.gamma_range)):
        p[name] = u(lo, hi)
        p[f"do_{name}"] = gate(prob)
    p["mirror"] = u(0.0, 1.0, dim) < 0.5 if cfg.do_mirror \
        else torch.zeros((batch, dim), dtype=torch.bool, device=device)
    if cfg.do_elastic:
        if patch is None or len(patch) != dim:
            raise ValueError(f"the elastic field needs the {dim}D patch, got {patch}")
        p["elastic"] = u(*cfg.elastic_magnitude)
        p["do_elastic"] = gate(cfg.p_eldef)
        p["elastic_field"] = u(-1.0, 1.0, dim,
                               *(max(2, s // cfg.elastic_grid) for s in patch))
    return p


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights of ``jax.image.resize(method="cubic")``
    along one axis (``jax/_src/image/scale.py:compute_weight_mat``):
    half-pixel sample positions, the kernel widened by the downscale
    factor when shrinking (antialiasing), each output column divided by
    its sum, no clamping of indices at the borders, and a sample outside
    the input's extent weighted 0."""
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = _keys_cubic(x.abs() / max(inv, 1.0))
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_cubic(x: torch.Tensor, shape) -> torch.Tensor:
    """``x [..., *spatial]`` resized on its trailing ``len(shape)`` axes to
    ``shape`` as ``jax.image.resize(method="cubic")`` does: one weight
    matrix per axis, applied in turn; an axis whose size does not change
    is left alone, as jax skips it."""
    lead = x.dim() - len(shape)
    for a, n_out in enumerate(shape):
        n_in = x.shape[lead + a]
        if n_in != n_out:
            w = cubic_weights(n_in, n_out, x.device).to(x.dtype)
            x = torch.movedim(torch.movedim(x, lead + a, -1) @ w, -1, lead + a)
    return x


def _rot_matrix(angles: torch.Tensor) -> torch.Tensor:
    """[B, 3] angles (x, y, z) -> [B, 3, 3] = Rz @ Ry @ Rx; [B, 1] -> 2D."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])
    if angles.shape[1] == 1:
        return torch.stack([torch.stack([c[:, 0], -s[:, 0]], -1),
                            torch.stack([s[:, 0], c[:, 0]], -1)], 1)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], 1)

    rx = mat([[one, zero, zero], [zero, c[:, 0], -s[:, 0]], [zero, s[:, 0], c[:, 0]]])
    ry = mat([[c[:, 1], zero, s[:, 1]], [zero, one, zero], [-s[:, 1], zero, c[:, 1]]])
    rz = mat([[c[:, 2], -s[:, 2], zero], [s[:, 2], c[:, 2], zero], [zero, zero, one]])
    return rz @ ry @ rx


def spatial_coords(params: dict, patch, cfg: AugmentConfig, device) -> torch.Tensor:
    """[B, dim, *patch] sampling coordinates: the output grid snapped to
    the low-resolution pitch, rotated and scaled about the patch centre,
    then displaced by the elastic field."""
    dim = len(patch)
    base = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=device) for s in patch],
        indexing="ij"))[None]                                   # [1, dim, *patch]
    shape = (-1,) + (1,) * (dim + 1)
    pitch = params["lowres"].reshape(shape)
    coords = torch.floor(base / pitch) * pitch
    if cfg.do_rotation or cfg.do_scaling:
        center = torch.tensor([(s - 1) / 2.0 for s in patch], device=device).reshape(
            (1, dim) + (1,) * dim)
        g = (coords - center).flatten(2)                         # [B, dim, P]
        g = _rot_matrix(params["angles"]) @ g
        coords = (g * params["scale"].reshape(-1, 1, 1)).reshape(coords.shape) + center
    if cfg.do_elastic:
        mag = torch.where(params["do_elastic"], params["elastic"], 0.0).reshape(shape)
        coords = coords + mag * resize_cubic(params["elastic_field"], patch)
    return coords


def _flat_index(idx: list, spatial) -> torch.Tensor:
    flat = idx[0]
    for a in range(1, len(spatial)):
        flat = flat * spatial[a] + idx[a]
    return flat


def _in_bounds(c: torch.Tensor, spatial) -> torch.Tensor:
    inb = torch.ones_like(c[:, 0], dtype=torch.bool)
    for a, s in enumerate(spatial):
        inb &= (c[:, a] >= 0) & (c[:, a] <= s - 1)
    return inb


def sample_linear(vol: torch.Tensor, coords: torch.Tensor, cval: float = 0.0):
    """Multilinear sampling: ``vol [B, C, *spatial]``, ``coords [B, dim,
    *out]`` in voxel units -> ``[B, C, *out]``; out of bounds -> cval."""
    B, C = vol.shape[:2]
    spatial = vol.shape[2:]
    dim = len(spatial)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    src = vol.reshape(B, C, -1)
    out = torch.zeros((B, C) + coords.shape[2:], dtype=vol.dtype, device=vol.device)
    for corner in range(2 ** dim):
        idx, w = [], 1.0
        for a in range(dim):
            bit = (corner >> a) & 1
            idx.append(torch.clamp(lo[:, a] + bit, 0, spatial[a] - 1))
            w = w * (frac[:, a] if bit else 1.0 - frac[:, a])
        flat = _flat_index(idx, spatial).reshape(B, 1, -1).expand(B, C, -1)
        out = out + w[:, None] * torch.gather(src, 2, flat).reshape(out.shape)
    return torch.where(_in_bounds(coords, spatial)[:, None], out, cval)


def sample_nearest(vol: torch.Tensor, coords: torch.Tensor, cval: float = -1.0):
    """Nearest sampling of ``vol [B, *spatial]`` at ``coords [B, dim, *out]``
    (rounded half to even, as ``jnp.round``); out of bounds -> cval."""
    B = vol.shape[0]
    spatial = vol.shape[1:]
    ri = torch.round(coords)
    idx = [torch.clamp(ri[:, a].long(), 0, s - 1) for a, s in enumerate(spatial)]
    out = torch.gather(vol.reshape(B, -1), 1,
                       _flat_index(idx, spatial).reshape(B, -1)).reshape(ri[:, 0].shape)
    return torch.where(_in_bounds(ri, spatial), out, torch.full_like(out, cval))


def gaussian_kernel7(sigma: torch.Tensor) -> torch.Tensor:
    """[B] sigmas -> [B, 7] normalized 7-tap Gaussian kernels."""
    x = torch.arange(-3, 4, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x[None] / torch.clamp(sigma[:, None], min=1e-3)) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian blur of ``x [B, C, *spatial]`` with one
    sigma per sample, zero padding (``_blur``'s SAME depthwise convs)."""
    B, C = x.shape[:2]
    dim = x.dim() - 2
    k = gaussian_kernel7(sigma).repeat_interleave(C, dim=0)      # [B*C, 7]
    h = x.reshape((1, B * C) + x.shape[2:])
    conv = {2: F.conv2d, 3: F.conv3d}[dim]
    for a in range(dim):
        shape = [1] * dim
        shape[a] = 7
        pad = [0] * dim
        pad[a] = 3
        h = conv(h, k.reshape([B * C, 1] + shape), padding=tuple(pad), groups=B * C)
    return h.reshape(x.shape)


def _gamma(x: torch.Tensor, g: torch.Tensor, invert: bool) -> torch.Tensor:
    """Gamma with retained statistics over each whole sample (all channels),
    as ``_augment_one``'s ``gamma_tf``."""
    axes = tuple(range(1, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 1)
    mean = x.mean(dim=axes, keepdim=True)
    std = x.std(dim=axes, unbiased=False, keepdim=True)
    mn = x.amin(dim=axes, keepdim=True)
    rng = x.amax(dim=axes, keepdim=True) - mn + 1e-7
    xn = (x - mn) / rng
    if invert:
        xn = 1.0 - xn
    xg = torch.pow(torch.clamp(xn, 1e-7, 1.0), g.reshape(shape))
    if invert:
        xg = 1.0 - xg
    xg = xg * rng + mn
    return (xg - xg.mean(dim=axes, keepdim=True)) \
        / (xg.std(dim=axes, unbiased=False, keepdim=True) + 1e-7) * std + mean


def apply_params(data: torch.Tensor, seg: torch.Tensor, params: dict,
                 cfg: AugmentConfig, noise: torch.Tensor | None = None):
    """``data [B, C, *patch]`` float32, ``seg [B, *patch]`` integer ->
    augmented (data, seg) of the same shapes and dtypes.  ``noise`` is the
    unit Gaussian field ``[B, C, *patch]`` that noise adds, scaled by the
    drawn standard deviation (needed when ``cfg.p_noise > 0``).  Like the
    JAX program, every enabled transform is computed for the whole batch and
    selected per sample, so nothing waits on the device for a gate."""
    dim = data.dim() - 2
    patch = data.shape[2:]

    def where(flag, new, old):
        return torch.where(flag.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)

    if cfg.do_rotation or cfg.do_scaling or cfg.p_lowres > 0 or cfg.do_elastic:
        coords = spatial_coords(params, patch, cfg, data.device)
        data = sample_linear(data, coords, 0.0)
        seg = sample_nearest(seg.float(), coords, -1.0).to(seg.dtype)
    if cfg.p_noise > 0:
        std = torch.sqrt(params["noise"]).reshape((-1,) + (1,) * (dim + 1))
        data = where(params["do_noise"], data + noise * std, data)
    if cfg.p_blur > 0:
        data = where(params["do_blur"], blur(data, params["blur"]), data)
    if cfg.p_brightness > 0:
        m = params["brightness"].reshape((-1,) + (1,) * (dim + 1))
        data = where(params["do_brightness"], data * m, data)
    if cfg.p_contrast > 0:
        f = params["contrast"].reshape((-1,) + (1,) * (dim + 1))
        axes = tuple(range(2, data.dim()))
        mean = data.mean(dim=axes, keepdim=True)
        dc = torch.clamp((data - mean) * f + mean, data.amin(dim=axes, keepdim=True),
                         data.amax(dim=axes, keepdim=True))
        data = where(params["do_contrast"], dc, data)
    if cfg.p_gamma_inverted > 0:
        data = where(params["do_gamma_inverted"],
                     _gamma(data, params["gamma_inverted"], True), data)
    if cfg.p_gamma > 0:
        data = where(params["do_gamma"], _gamma(data, params["gamma"], False), data)
    if cfg.do_mirror:
        for a in cfg.mirror_axes:
            if a < dim:
                flag = params["mirror"][:, a]
                data = where(flag, data.flip(a + 2), data)
                seg = where(flag, seg.flip(a + 1), seg)
    return data, seg


def augment_batch(data: torch.Tensor, seg: torch.Tensor, cfg: AugmentConfig,
                  generator: torch.Generator, rows: tuple | None = None):
    """Draw and apply one batch's augmentation on ``data``'s device.
    ``rows=(lo, hi, B)``: ``data`` holds rows ``[lo, hi)`` of a global batch
    of ``B`` (a data-parallel rank); the parameters and the noise are drawn
    for all ``B`` from the generator, which every rank seeds alike, and
    this rank keeps its rows, so N ranks augment as one rank would."""
    lo, hi, total = rows or (0, data.shape[0], data.shape[0])
    params = draw_params(total, data.dim() - 2, cfg, generator, data.device,
                         patch=tuple(data.shape[2:]))
    noise = torch.randn((total,) + tuple(data.shape[1:]), generator=generator,
                        device=data.device) if cfg.p_noise > 0 else None
    if (lo, hi) != (0, total):
        params = {k: v[lo:hi] for k, v in params.items()}
        noise = noise[lo:hi] if noise is not None else None
    return apply_params(data, seg, params, cfg, noise)
