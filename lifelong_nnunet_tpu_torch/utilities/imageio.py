"""Multi-format medical image I/O: NIfTI, NRRD, MetaImage (.mha/.mhd).

The reference reads every format SimpleITK supports (evaluator2.py:86
``sitk.ReadImage``; upstream export via ``save_segmentation_nifti``).  That
wheel is not in this environment, so the clinically common containers are
implemented directly on numpy: NIfTI-1 (``utilities/nifti.py``), NRRD
(teem spec, raw/gzip encodings) and MetaImage (.mha single-file and .mhd
detached-header, raw/zlib).  All formats round-trip through the common
:class:`~lifelong_nnunet_tpu_torch.utilities.nifti.NiftiImage` container (data in
index order, per-axis spacing, 4x4 affine), so every pipeline stage —
preprocessing fingerprint, inference, evaluation, label mapping — works on
any supported format.

``read_image``/``write_image`` dispatch on extension; the NIfTI functions
stay importable from ``utilities.nifti`` unchanged.
"""

from __future__ import annotations

import gzip
import os
import zlib

import numpy as np

from .nifti import NiftiImage, read as read_nifti, write as write_nifti

# ----------------------------------------------------------------- NRRD

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "signed short": np.int16, "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_TYPE_NAMES = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def _parse_nrrd_vector(s: str):
    """'(a,b,c)' -> [a, b, c]; 'none' -> None."""
    s = s.strip()
    if s == "none":
        return None
    return [float(x) for x in s.strip("()").split(",")]


def read_nrrd(path: str) -> NiftiImage:
    """Teem-NRRD reader: NRRD000x magic, ``key: value`` header lines up to a
    blank line, then the data blob (raw or gzip).  Detached-data files
    (``data file:``) are resolved relative to the header."""
    with open(path, "rb") as f:
        blob = f.read()
    nl = blob.index(b"\n")
    magic = blob[:nl].decode("ascii", "replace").strip()
    if not magic.startswith("NRRD"):
        raise ValueError(f"{path}: not a NRRD file (magic {magic!r})")
    # header ends at the first blank line
    end = blob.index(b"\n\n") if b"\n\n" in blob else len(blob)
    fields = {}
    for line in blob[nl + 1:end].decode("ascii", "replace").splitlines():
        if line.startswith("#") or not line.strip():
            continue
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        fields[k.strip().lower()] = v.lstrip("=").strip()
    payload = blob[end + 2:]
    if "data file" in fields or "datafile" in fields:
        dfile = fields.get("data file", fields.get("datafile"))
        with open(os.path.join(os.path.dirname(path) or ".", dfile), "rb") as f:
            payload = f.read()

    tname = fields["type"].strip()
    if tname not in _NRRD_TYPES:
        raise ValueError(f"{path}: unsupported NRRD type {tname!r}")
    dtype = np.dtype(_NRRD_TYPES[tname])
    if dtype.itemsize > 1:
        endian = fields.get("endian", "little")
        dtype = dtype.newbyteorder("<" if endian == "little" else ">")
    sizes = [int(x) for x in fields["sizes"].split()]
    encoding = fields.get("encoding", "raw").strip()
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding != "raw":
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r}")
    count = int(np.prod(sizes))
    data = np.frombuffer(payload, dtype=dtype, count=count)
    data = data.astype(data.dtype.newbyteorder("<"))
    # NRRD sizes are fastest-first; numpy C order is fastest-last
    data = np.ascontiguousarray(data.reshape(sizes[::-1]).transpose())

    affine = np.eye(4)
    spacing = [1.0] * min(3, len(sizes))
    if "space directions" in fields:
        dirs = [_parse_nrrd_vector(v)
                for v in fields["space directions"].split(") ")]
        dirs = [d for d in dirs if d is not None]
        for a, d in enumerate(dirs[:3]):
            vec = np.asarray(d[:3], np.float64)
            affine[:3, a] = vec
            if a < len(spacing):
                spacing[a] = float(np.linalg.norm(vec))
    elif "spacings" in fields:
        sp = [float(x) for x in fields["spacings"].split()]
        for a, s in enumerate(sp[:3]):
            affine[a, a] = s
            if a < len(spacing):
                spacing[a] = s
    if "space origin" in fields:
        org = _parse_nrrd_vector(fields["space origin"])
        affine[:3, 3] = (org + [0.0] * 3)[:3]
    spacing = tuple(spacing) + (1.0,) * (3 - len(spacing))
    return NiftiImage(data=data, spacing=spacing, affine=affine)


def write_nrrd(path: str, img: NiftiImage, compress: bool = True) -> None:
    data = np.asarray(img.data)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _NRRD_TYPE_NAMES:
        data = data.astype(np.float32)
    dirs = []
    aff = np.asarray(img.affine, np.float64)
    for a in range(data.ndim):
        if a < 3:
            col = aff[:3, a]
            if not np.any(col):
                col = np.eye(3)[a] * (img.spacing[a] if a < len(img.spacing) else 1.0)
            dirs.append("(" + ",".join(f"{x:.17g}" for x in col) + ")")
        else:
            dirs.append("none")
    lines = [
        "NRRD0004",
        "# written by lifelong_nnunet_tpu",
        f"type: {_NRRD_TYPE_NAMES[np.dtype(data.dtype)]}",
        f"dimension: {data.ndim}",
        "space: left-posterior-superior",
        "sizes: " + " ".join(str(s) for s in data.shape),
        "space directions: " + " ".join(dirs),
        "kinds: " + " ".join(["domain"] * data.ndim),
        "endian: little",
        f"encoding: {'gzip' if compress else 'raw'}",
        "space origin: (" + ",".join(f"{x:.17g}" for x in aff[:3, 3]) + ")",
        "",
        "",
    ]
    payload = np.ascontiguousarray(data.transpose()).tobytes()  # fastest-first
    if compress:
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode("ascii"))
        f.write(payload)


# ----------------------------------------------------- MetaImage (.mha/.mhd)

_MET_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_TYPE_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read_mha(path: str) -> NiftiImage:
    """MetaImage reader: ``Key = Value`` ASCII header ending at
    ``ElementDataFile``; LOCAL data follows in-file (.mha), otherwise the
    named file holds it (.mhd).  CompressedData uses zlib."""
    with open(path, "rb") as f:
        blob = f.read()
    fields = {}
    pos = 0
    data_file = None
    while pos < len(blob):
        nl = blob.find(b"\n", pos)
        if nl < 0:
            nl = len(blob)
        line = blob[pos:nl].decode("ascii", "replace").strip()
        pos = nl + 1
        if not line or "=" not in line:
            continue
        k, v = (x.strip() for x in line.split("=", 1))
        fields[k] = v
        if k == "ElementDataFile":
            data_file = v
            break
    if data_file is None:
        raise ValueError(f"{path}: no ElementDataFile key — not a MetaImage")
    if data_file == "LOCAL":
        payload = blob[pos:]
    else:
        with open(os.path.join(os.path.dirname(path) or ".", data_file), "rb") as f:
            payload = f.read()

    tname = fields.get("ElementType", "MET_FLOAT")
    if tname not in _MET_TYPES:
        raise ValueError(f"{path}: unsupported ElementType {tname!r}")
    dtype = np.dtype(_MET_TYPES[tname])
    if fields.get("BinaryDataByteOrderMSB", "False").lower() == "true" or \
       fields.get("ElementByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    sizes = [int(x) for x in fields["DimSize"].split()]
    if fields.get("CompressedData", "False").lower() == "true":
        payload = zlib.decompress(payload)
    count = int(np.prod(sizes))
    data = np.frombuffer(payload, dtype=dtype, count=count)
    data = data.astype(data.dtype.newbyteorder("<"))
    data = np.ascontiguousarray(data.reshape(sizes[::-1]).transpose())

    ndim = len(sizes)
    spacing = [float(x) for x in fields.get(
        "ElementSpacing", " ".join(["1"] * ndim)).split()]
    affine = np.eye(4)
    if "TransformMatrix" in fields:
        m = np.asarray([float(x) for x in fields["TransformMatrix"].split()])
        if m.size == ndim * ndim and ndim <= 3:
            # row-major direction cosines; columns scale by spacing
            rot = m.reshape(ndim, ndim).T
            for a in range(ndim):
                affine[:ndim, a] = rot[:, a] * spacing[a]
    else:
        for a in range(min(3, ndim)):
            affine[a, a] = spacing[a]
    if "Offset" in fields:
        off = [float(x) for x in fields["Offset"].split()]
        affine[:len(off[:3]), 3] = off[:3]
    sp = tuple(spacing[:3]) + (1.0,) * max(0, 3 - ndim)
    return NiftiImage(data=data, spacing=sp, affine=affine)


def write_mha(path: str, img: NiftiImage, compress: bool = True) -> None:
    data = np.asarray(img.data)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _MET_TYPE_NAMES:
        data = data.astype(np.float32)
    aff = np.asarray(img.affine, np.float64)
    ndim = data.ndim
    spacing = [img.spacing[a] if a < len(img.spacing) else 1.0
               for a in range(ndim)]
    rot = np.eye(ndim)
    for a in range(min(3, ndim)):
        col = aff[:min(3, ndim), a]
        n = np.linalg.norm(col)
        if n > 0:
            spacing[a] = float(n)
            rot[:min(3, ndim), a] = col / n
    payload = np.ascontiguousarray(data.transpose()).tobytes()
    if compress:
        comp = zlib.compress(payload)
        comp_lines = ["CompressedData = True",
                      f"CompressedDataSize = {len(comp)}"]
        payload = comp
    else:
        comp_lines = ["CompressedData = False"]
    lines = [
        "ObjectType = Image",
        f"NDims = {ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        *comp_lines,
        "TransformMatrix = " + " ".join(f"{x:.17g}" for x in rot.T.ravel()),
        "Offset = " + " ".join(f"{x:.17g}" for x in aff[:min(3, ndim), 3]),
        "ElementSpacing = " + " ".join(f"{x:.17g}" for x in spacing),
        "DimSize = " + " ".join(str(s) for s in data.shape),
        f"ElementType = {_MET_TYPE_NAMES[np.dtype(data.dtype)]}",
        "ElementDataFile = LOCAL",
        "",
    ]
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode("ascii"))
        f.write(payload)


# ------------------------------------------------------------ dispatcher

READABLE_SUFFIXES = (".nii.gz", ".nii", ".nrrd", ".nhdr", ".mha", ".mhd")


def image_suffix(path: str):
    """The recognized image suffix of ``path`` (longest match), or None."""
    low = str(path).lower()
    for suf in READABLE_SUFFIXES:
        if low.endswith(suf):
            return suf
    return None


def read_image(path: str) -> NiftiImage:
    suf = image_suffix(path)
    if suf in (".nrrd", ".nhdr"):
        return read_nrrd(path)
    if suf in (".mha", ".mhd"):
        return read_mha(path)
    return read_nifti(path)  # .nii/.nii.gz or raise its own format error


def write_image(path: str, img: NiftiImage) -> None:
    suf = image_suffix(path)
    if suf in (".nrrd", ".nhdr"):
        write_nrrd(path, img)
    elif suf in (".mha", ".mhd"):
        write_mha(path, img)
    else:
        write_nifti(path, img)
