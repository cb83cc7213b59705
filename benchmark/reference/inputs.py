"""The plain reference of what a train step is fed: nnU-Net's patch
sampler with foreground oversampling, and moreDA's augmentation, drawn as
the trainer draws them.

The sampler's random stream is ``np.random.RandomState(seed)``: for each
of the B samples a case, then (2D) a slice, then the origin; the last
``round(B * oversample)`` samples are centred on a stored location of a
random foreground class.  Out-of-volume voxels are 0 (data) and -1 (seg).

The augmentation draws every per-sample parameter from a
``torch.Generator`` on the batch's device, in nnU-Net's moreDA order
(rotation p 0.2 +-30 deg, scale p 0.2 0.7-1.4, low resolution p 0.25
pitch 1-2, noise p 0.1 var 0-0.1, blur p 0.2 sigma 0.5-1, brightness p
0.15 0.75-1.25, contrast p 0.15, inverted gamma p 0.1 and gamma p 0.3
0.7-1.5, mirroring p 0.5 per axis), then a unit Gaussian field for the
noise, and applies them: one resample of the output grid (snapped to the
low-resolution pitch, rotated Rz Ry Rx and scaled about the patch centre)
by multilinear (data, 0 outside) and nearest (seg, -1 outside) sampling,
then noise, blur, brightness, contrast, the gammas and the mirrors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ROT_MAX = math.radians(30.0)


class Sampler:
    def __init__(self, arrays: list, locations: list, patch, batch: int,
                 oversample: float, seed: int):
        """``arrays``: [C + 1, *spatial] per case (labels last), in case
        order; ``locations``: {class: [n, 3] coords} per case."""
        self.arrays, self.locations = arrays, locations
        self.patch, self.batch, self.oversample = tuple(patch), batch, oversample
        self.rng = np.random.RandomState(seed)

    def _origin(self, spatial, locs, fg: bool, z=None):
        p, rng = self.patch, self.rng
        classes = [c for c, v in locs.items() if len(v) > 0] if fg else []
        if not classes:
            return [rng.randint(min(0, spatial[a] - p[a]), max(1, spatial[a] - p[a] + 1))
                    for a in range(len(p))]
        pts = locs[classes[rng.randint(len(classes))]]
        if z is not None:
            on = pts[pts[:, 0] == z]
            pts = on if len(on) else pts
        centre = pts[rng.randint(len(pts))][-len(p):]
        return [int(centre[a]) - p[a] // 2 for a in range(len(p))]

    def _crop(self, arr, lo):
        p = self.patch
        spatial = arr.shape[1:]
        sl, pads = [], [(0, 0)]
        for a in range(len(p)):
            sl.append(slice(max(0, lo[a]), min(spatial[a], lo[a] + p[a])))
            pads.append((max(0, -lo[a]), max(0, lo[a] + p[a] - spatial[a])))
        crop = np.asarray(arr[(slice(None),) + tuple(sl)])
        return (np.pad(crop[:-1], pads, constant_values=0.0),
                np.pad(crop[-1:], pads, constant_values=-1.0)[0])

    def next_batch(self):
        """(data [B, C, *patch] float32, seg [B, *patch] int8)."""
        data, seg = [], []
        for i in range(self.batch):
            k = self.rng.randint(len(self.arrays))
            arr, locs = self.arrays[k], self.locations[k]
            fg = i >= round(self.batch * (1 - self.oversample))
            if len(self.patch) == 2:
                z = self.rng.randint(arr.shape[1])
                arr = arr[:, z]
                lo = self._origin(arr.shape[1:], locs, fg, z)
            else:
                lo = self._origin(arr.shape[1:], locs, fg)
            d, s = self._crop(arr, lo)
            data.append(d)
            seg.append(s)
        return np.stack(data).astype(np.float32), np.stack(seg).astype(np.int8)


def draw(gen: torch.Generator, batch: int, dim: int, device) -> dict:
    def u(lo=0.0, hi=1.0, *shape):
        return lo + (hi - lo) * torch.rand((batch,) + shape, generator=gen, device=device)

    p = {}
    angles = u(-ROT_MAX, ROT_MAX, 3 if dim == 3 else 1)
    p["angles"] = torch.where((u() < 0.2)[:, None], angles, 0.0)
    gate = u() < 0.2
    p["scale"] = torch.where(gate, u(0.7, 1.4), 1.0)
    gate = u() < 0.25
    p["pitch"] = torch.where(gate, u(1.0, 2.0), 1.0)
    for name, prob, lo, hi in (("noise", 0.1, 0.0, 0.1), ("blur", 0.2, 0.5, 1.0),
                               ("bright", 0.15, 0.75, 1.25), ("contrast", 0.15, 0.75, 1.25),
                               ("igamma", 0.1, 0.7, 1.5), ("gamma", 0.3, 0.7, 1.5)):
        p[name] = u(lo, hi)
        p[f"do_{name}"] = u() < prob
    p["mirror"] = u(0.0, 1.0, dim) < 0.5
    return p


def _rotation(angles):
    c, s = torch.cos(angles), torch.sin(angles)
    if angles.shape[1] == 1:
        return torch.stack([torch.stack([c[:, 0], -s[:, 0]], -1),
                            torch.stack([s[:, 0], c[:, 0]], -1)], 1)
    B = angles.shape[0]
    eye = torch.eye(3, device=angles.device).expand(B, 3, 3)

    def about(axis, a):
        i, j = [k for k in range(3) if k != axis]
        m = eye.clone()
        m[:, i, i], m[:, i, j], m[:, j, i], m[:, j, j] = \
            torch.cos(a), -torch.sin(a), torch.sin(a), torch.cos(a)
        if axis == 1:       # Ry keeps the right-handed sign convention
            m[:, i, j], m[:, j, i] = torch.sin(a), -torch.sin(a)
        return m

    return about(2, angles[:, 2]) @ about(1, angles[:, 1]) @ about(0, angles[:, 0])


def _coords(p, patch, device):
    dim = len(patch)
    grid = torch.stack(torch.meshgrid(*[torch.arange(s, device=device, dtype=torch.float32)
                                        for s in patch], indexing="ij"))
    pitch = p["pitch"].view((-1,) + (1,) * (dim + 1))
    grid = torch.floor(grid[None] / pitch) * pitch
    centre = torch.tensor([(s - 1) / 2 for s in patch], device=device).view(1, dim, 1)
    flat = grid.flatten(2) - centre
    flat = (_rotation(p["angles"]) @ flat) * p["scale"].view(-1, 1, 1) + centre
    return flat.view(grid.shape)


def _inside(c, spatial):
    ok = torch.ones_like(c[:, 0], dtype=torch.bool)
    for a, s in enumerate(spatial):
        ok &= (c[:, a] >= 0) & (c[:, a] <= s - 1)
    return ok


def _index(idx, spatial):
    flat = idx[0]
    for a in range(1, len(spatial)):
        flat = flat * spatial[a] + idx[a]
    return flat


def resample_linear(vol, c):
    """vol [B, C, *S] at coords c [B, dim, *S] (voxels): multilinear, 0 outside."""
    B, C = vol.shape[:2]
    spatial = vol.shape[2:]
    lo = torch.floor(c)
    fr = c - lo
    lo = lo.long()
    src = vol.reshape(B, C, -1)
    out = torch.zeros_like(vol)
    for corner in range(2 ** len(spatial)):
        idx, w = [], 1.0
        for a, s in enumerate(spatial):
            bit = (corner >> a) & 1
            idx.append(torch.clamp(lo[:, a] + bit, 0, s - 1))
            w = w * (fr[:, a] if bit else 1.0 - fr[:, a])
        flat = _index(idx, spatial).reshape(B, 1, -1).expand(B, C, -1)
        out += w[:, None] * torch.gather(src, 2, flat).view(out.shape)
    return torch.where(_inside(c, spatial)[:, None], out, 0.0)


def resample_nearest(seg, c):
    B, spatial = seg.shape[0], seg.shape[1:]
    r = torch.round(c)
    idx = [torch.clamp(r[:, a].long(), 0, s - 1) for a, s in enumerate(spatial)]
    out = torch.gather(seg.reshape(B, -1), 1, _index(idx, spatial).reshape(B, -1))
    return torch.where(_inside(r, spatial), out.view(seg.shape), -1.0)


def _blur(x, sigma):
    B, C = x.shape[:2]
    dim = x.dim() - 2
    t = torch.arange(-3, 4, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t[None] / sigma[:, None].clamp(min=1e-3)) ** 2)
    k = (k / k.sum(1, keepdim=True)).repeat_interleave(C, 0)
    conv = {2: F.conv2d, 3: F.conv3d}[dim]
    h = x.reshape((1, B * C) + x.shape[2:])
    for a in range(dim):
        shape, pad = [1] * dim, [0] * dim
        shape[a], pad[a] = 7, 3
        h = conv(h, k.view([B * C, 1] + shape), padding=tuple(pad), groups=B * C)
    return h.view(x.shape)


def _gamma(x, g, invert):
    axes = tuple(range(1, x.dim()))
    mean, sd = x.mean(axes, keepdim=True), x.std(axes, unbiased=False, keepdim=True)
    lo = x.amin(axes, keepdim=True)
    span = x.amax(axes, keepdim=True) - lo + 1e-7
    n = (x - lo) / span
    n = 1.0 - n if invert else n
    y = torch.clamp(n, 1e-7, 1.0) ** g.view((-1,) + (1,) * (x.dim() - 1))
    y = (1.0 - y if invert else y) * span + lo
    return (y - y.mean(axes, keepdim=True)) / (y.std(axes, unbiased=False, keepdim=True)
                                               + 1e-7) * sd + mean


def augment(data, seg, gen: torch.Generator):
    """moreDA on a batch: (data [B, C, *S] float32, seg [B, *S] int8)."""
    B, dim = data.shape[0], data.dim() - 2
    p = draw(gen, B, dim, data.device)
    noise = torch.randn(tuple(data.shape), generator=gen, device=data.device)
    c = _coords(p, data.shape[2:], data.device)
    data = resample_linear(data, c)
    seg = resample_nearest(seg.float(), c).to(torch.int8)

    def pick(flag, new, old):
        return torch.where(flag.view((-1,) + (1,) * (old.dim() - 1)), new, old)

    shp = (-1,) + (1,) * (dim + 1)
    data = pick(p["do_noise"], data + noise * torch.sqrt(p["noise"]).view(shp), data)
    data = pick(p["do_blur"], _blur(data, p["blur"]), data)
    data = pick(p["do_bright"], data * p["bright"].view(shp), data)
    axes = tuple(range(2, data.dim()))
    mean = data.mean(axes, keepdim=True)
    con = torch.clamp((data - mean) * p["contrast"].view(shp) + mean,
                      data.amin(axes, keepdim=True), data.amax(axes, keepdim=True))
    data = pick(p["do_contrast"], con, data)
    data = pick(p["do_igamma"], _gamma(data, p["igamma"], True), data)
    data = pick(p["do_gamma"], _gamma(data, p["gamma"], False), data)
    for a in range(dim):
        flag = p["mirror"][:, a]
        data = pick(flag, data.flip(a + 2), data)
        seg = pick(flag, seg.flip(a + 1), seg)
    return data, seg
