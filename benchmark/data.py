"""The benchmark's inputs, made from ``--seed``: synthetic abdominal CT
volumes with their labels, made on the device in a few large calls, and
the files the program reads them from (the preprocessed stage folder that
the trainer samples, raw NIfTI images that serving reads), with a minimal
NIfTI-1 reader and writer of the benchmark's own.

A case's shape comes from the traffic file; the seed draws its anatomy
and noise.  Intensities are Hounsfield units: air -1000 outside an
elliptic body of soft tissue (40), a spine (500), two kidneys (150,
class 1) and one tumour in one of them (80, class 2), plus Gaussian noise
(sd 20).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

MAX_CLASS_LOC_SAMPLES = 10000


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(index)])


def make_case(shape, seed: int, index: int, device) -> tuple:
    """(hu int16 [Z, Y, X], seg uint8 [Z, Y, X]) on ``device``."""
    Z, Y, X = (int(s) for s in shape)
    r = _rng(seed, index)
    z = torch.arange(Z, device=device, dtype=torch.float32)[:, None, None] / Z
    y = torch.arange(Y, device=device, dtype=torch.float32)[None, :, None] / Y
    x = torch.arange(X, device=device, dtype=torch.float32)[None, None, :] / X

    def ellipsoid(c, rad):
        return ((z - c[0]) / rad[0]) ** 2 + ((y - c[1]) / rad[1]) ** 2 \
            + ((x - c[2]) / rad[2]) ** 2

    body = ((y - 0.5) / r.uniform(0.40, 0.46)) ** 2 + ((x - 0.5) / r.uniform(0.42, 0.47)) ** 2 < 1
    hu = torch.where(body, 40.0, -1000.0).expand(Z, Y, X).clone()
    spine = ((y - 0.72) / 0.06) ** 2 + ((x - 0.5) / 0.05) ** 2 < 1
    hu = torch.where(spine.expand(Z, Y, X), 500.0, hu)
    seg = torch.zeros((Z, Y, X), dtype=torch.uint8, device=device)
    tumour_in = int(r.integers(2))
    for side, xc in enumerate((0.3, 0.7)):
        c = (r.uniform(0.4, 0.6), r.uniform(0.55, 0.62), xc + r.uniform(-0.03, 0.03))
        rad = (r.uniform(0.22, 0.3), r.uniform(0.08, 0.1), r.uniform(0.06, 0.08))
        kidney = ellipsoid(c, rad) < 1
        hu = torch.where(kidney, 150.0, hu)
        seg[kidney] = 1
        if side == tumour_in:
            tc = tuple(a + b * r.uniform(-0.4, 0.4) for a, b in zip(c, rad))
            trad = tuple(b * r.uniform(0.35, 0.55) for b in rad)
            tumour = ellipsoid(tc, trad) < 1
            hu = torch.where(tumour, 80.0, hu)
            seg[tumour] = 2
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1009 + index) % 2 ** 63)
    hu = hu + 20.0 * torch.randn((Z, Y, X), generator=gen, device=device)
    return torch.clamp(torch.round(hu), -1024, 3071).to(torch.int16), seg


def ct_normalize(hu: torch.Tensor, props: dict) -> torch.Tensor:
    """nnU-Net's CT normalization: clip to the 0.5 / 99.5 percentiles of
    the foreground, subtract its mean, divide by its sd."""
    x = torch.clamp(hu.float(), props["percentile_00_5"], props["percentile_99_5"])
    return (x - props["mean"]) / max(props["sd"], 1e-8)


def class_locations(seg: torch.Tensor, classes, seed: int, index: int) -> dict:
    """Up to MAX_CLASS_LOC_SAMPLES voxel coordinates of each class present."""
    gen = torch.Generator(device=seg.device).manual_seed((int(seed) * 7 + index) % 2 ** 63)
    out = {}
    for c in classes:
        coords = torch.nonzero(seg == c)
        if len(coords) == 0:
            continue
        if len(coords) > MAX_CLASS_LOC_SAMPLES:
            pick = torch.randperm(len(coords), generator=gen, device=seg.device)
            coords = coords[pick[:MAX_CLASS_LOC_SAMPLES]]
        out[int(c)] = coords.to(torch.int32).cpu().numpy()
    return out


def write_stage(stage_dir: str, config: dict, shapes, seed: int, device) -> list:
    """The preprocessed stage folder of the training cases, what the
    trainer's sampler reads: ``<case>.npy`` [2, Z, Y, X] float32
    (normalized CT and labels) and ``<case>.classlocs.npz``.  Returns the
    case names, sorted."""
    os.makedirs(stage_dir, exist_ok=True)
    plans = config["plans"]
    props = plans["intensity_properties"]["0"]
    names = []
    for i, shape in enumerate(shapes):
        name = f"case_{i:03d}"
        hu, seg = make_case(shape, seed, i, device)
        stacked = torch.stack([ct_normalize(hu, props), seg.float()])
        np.save(os.path.join(stage_dir, f"{name}.npy"), stacked.cpu().numpy())
        locs = class_locations(seg, plans["all_classes"], seed, i)
        np.savez(os.path.join(stage_dir, f"{name}.classlocs.npz"),
                 **{str(k): v for k, v in locs.items()})
        names.append(name)
        del hu, seg, stacked
    return sorted(names)


# ------------------------------------------------------------------ NIfTI-1
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16}
_TYPES = {v: k for k, v in _CODES.items()}


def write_nifti(path: str, arr: np.ndarray, spacing) -> None:
    """An uncompressed (``.nii``) or gzipped (``.nii.gz``) NIfTI-1 file of
    ``arr [i, j, k]``, its affine the diagonal of ``spacing``."""
    arr = np.asarray(arr)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *arr.shape, 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, _CODES[arr.dtype], arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *(float(s) for s in spacing), 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    hdr[344:348] = b"n+1\x00"
    body = bytes(hdr) + b"\x00" * 4 + np.ascontiguousarray(arr.T).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body)


def read_nifti(path: str) -> np.ndarray:
    """The voxel array ``[i, j, k]`` of a little-endian NIfTI-1 file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", raw, 40)
    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    dtype = _TYPES[struct.unpack_from("<h", raw, 70)[0]]
    off = int(struct.unpack_from("<f", raw, 108)[0])
    slope, inter = struct.unpack_from("<2f", raw, 112)
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)), offset=off)
    data = data.reshape(shape[::-1]).transpose(tuple(range(len(shape)))[::-1])
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data.astype(np.float32) * slope + inter
    return np.ascontiguousarray(data)


def write_raw_cases(folder: str, config: dict, shapes, seed: int, device) -> list:
    """Raw CT images ``case_XXX_0000.nii`` (int16 HU, at the plans' target
    spacing, so serving resamples nothing); returns [(name, hu int16 numpy)]
    in case order."""
    os.makedirs(folder, exist_ok=True)
    cfg = config["plans"]["configurations"][config["config_name"]]
    out = []
    for i, shape in enumerate(shapes):
        name = f"case_{i:03d}"
        hu, _ = make_case(shape, seed, i, device)
        hu = hu.cpu().numpy()
        write_nifti(os.path.join(folder, f"{name}_0000.nii"), hu, cfg["spacing"][-3:])
        out.append((name, hu))
    return out
