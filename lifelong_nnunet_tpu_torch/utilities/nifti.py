"""Minimal, dependency-free NIfTI-1 reader/writer.

The reference relies on SimpleITK for image I/O (via upstream nnU-Net). That
wheel is not available here, and all we need from it is: voxel data, voxel
spacing, the affine (direction/origin), and round-trip write — so we implement
the NIfTI-1 container directly on numpy.  Supports .nii and .nii.gz, the
common datatypes, qform/sform affines, and scl_slope/scl_inter scaling.

Data is returned in array index order ``(i, j, k[, t])`` matching the on-disk
Fortran layout transposed to C order, i.e. ``data[i, j, k]``; ``spacing`` is
per-axis in the same (i, j, k) order.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray                      # shape (i, j, k) or (i, j, k, t)
    spacing: tuple = (1.0, 1.0, 1.0)      # voxel size per spatial axis
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))

    @property
    def shape(self):
        return self.data.shape


def _quaternion_to_rotation(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])


def read(path: str) -> NiftiImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    # endianness is signalled by which byte order makes sizeof_hdr read 348
    # (nifti1.h convention; the reference reads these via SimpleITK which
    # handles both — evaluator2.py:86)
    if struct.unpack_from("<i", hdr, 0)[0] == 348:
        eo = "<"
    elif struct.unpack_from(">i", hdr, 0)[0] == 348:
        eo = ">"
    else:
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from(f"{eo}8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from(f"{eo}h", hdr, 70)[0]
    pixdim = struct.unpack_from(f"{eo}8f", hdr, 76)
    vox_offset = int(struct.unpack_from(f"{eo}f", hdr, 108)[0])
    scl_slope = struct.unpack_from(f"{eo}f", hdr, 112)[0]
    scl_inter = struct.unpack_from(f"{eo}f", hdr, 116)[0]
    qform_code = struct.unpack_from(f"{eo}h", hdr, 252)[0]
    sform_code = struct.unpack_from(f"{eo}h", hdr, 254)[0]

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(eo)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    if eo == ">":  # native little-endian arrays downstream
        data = data.astype(data.dtype.newbyteorder("<"))
    # NIfTI stores Fortran order: first axis fastest.
    data = data.reshape(shape[::-1]).transpose(tuple(range(len(shape)))[::-1])
    if scl_slope not in (0.0, 1.0) or scl_inter not in (0.0,):
        if scl_slope == 0.0:
            scl_slope = 1.0
        data = data.astype(np.float32) * scl_slope + scl_inter
    else:
        data = np.ascontiguousarray(data)

    affine = np.eye(4)
    if sform_code > 0:
        srow_x = struct.unpack_from(f"{eo}4f", hdr, 280)
        srow_y = struct.unpack_from(f"{eo}4f", hdr, 296)
        srow_z = struct.unpack_from(f"{eo}4f", hdr, 312)
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        b, c, d = struct.unpack_from(f"{eo}3f", hdr, 256)
        qx, qy, qz = struct.unpack_from(f"{eo}3f", hdr, 268)
        rot = _quaternion_to_rotation(b, c, d)
        qfac = pixdim[0] if pixdim[0] != 0 else 1.0
        scales = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine[:3, :3] = rot * scales
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine[0, 0] = pixdim[1] or 1.0
        affine[1, 1] = pixdim[2] or 1.0
        affine[2, 2] = pixdim[3] or 1.0

    nspatial = min(ndim, 3)
    spacing = tuple(float(pixdim[i + 1]) if pixdim[i + 1] > 0 else 1.0 for i in range(nspatial))
    if nspatial < 3:
        spacing = spacing + (1.0,) * (3 - nspatial)
    return NiftiImage(data=data, spacing=spacing, affine=affine)


def write(path: str, img: NiftiImage) -> None:
    data = np.asarray(img.data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dtype_code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)  # 348-byte header + 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, dtype_code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    spacing = tuple(img.spacing) + (1.0,) * max(0, 7 - len(img.spacing))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing[:7])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = 1
    aff = np.asarray(img.affine, dtype=np.float64)
    struct.pack_into("<4f", hdr, 280, *aff[0])
    struct.pack_into("<4f", hdr, 296, *aff[1])
    struct.pack_into("<4f", hdr, 312, *aff[2])
    hdr[344:348] = b"n+1\x00"

    # back to Fortran order on disk
    payload = data.transpose(tuple(range(data.ndim))[::-1]).tobytes()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(payload)
