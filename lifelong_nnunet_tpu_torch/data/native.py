"""The host patch gather in C++ (``data/csrc/patch_gather.cpp``), bound with
ctypes: the port of ``lifelong_nnunet_tpu/data/native.py``, writing the
port's channels-first layout.

The library is built by ``g++`` at first use into ``build/native/`` of the
checkout (``.gitignore`` lists ``build/``; a copy installed outside a
checkout builds under the user's cache directory).  Its file name carries
a hash of the source, so an edited source builds a new library and no
loaded library is ever rewritten; the compiler writes a temporary name in
the same directory and ``os.replace`` puts it in place, so a process that
loads the library while another builds it sees either no file or a whole
one.  A failed build raises with the compiler's output: nothing falls back
to the numpy path on its own (``PatchSampler(native=False)`` asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "patch_gather.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: dict = {}


def build_dir() -> Path:
    """``build/native/`` of the checkout the package lies in, else a
    directory under the user's cache (``$XDG_CACHE_HOME``, default
    ``~/.cache``)."""
    root = Path(__file__).resolve().parents[2]
    if (root / "setup.py").is_file():
        return root / "build" / "native"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(Path.home(), ".cache")
    return Path(cache) / "lifelong_nnunet_tpu_torch" / "native"


def library_path(out_dir: Path | None = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return Path(out_dir or build_dir()) / f"libpatch_gather_{digest.hexdigest()[:12]}.so"


def build_library(out_dir: Path | None = None, force: bool = False) -> Path:
    """Compile the source into :func:`library_path` unless it is there (or
    ``force``); returns the path.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    lib = library_path(out_dir)
    if lib.is_file() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the patch gather failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the patch gather failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(out_dir: Path | None = None) -> ctypes.CDLL:
    """The library, built on first use, loaded once per path."""
    with _lock:
        path = build_library(out_dir)
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.gather_patches_cf.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),   # case pointers
                ctypes.POINTER(ctypes.c_int64),    # case shapes [B, 4]
                ctypes.POINTER(ctypes.c_int64),    # origins [B, 3]
                ctypes.POINTER(ctypes.c_int64),    # patch [3]
                ctypes.c_int64, ctypes.c_int64,    # B, threads
                ctypes.POINTER(ctypes.c_float),    # data out
                ctypes.POINTER(ctypes.c_int8),     # seg out
            ]
            lib.gather_patches_cf.restype = None
            _libs[path] = lib
        return lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_patches(arrays: list, origins, patch, n_threads: int = 0):
    """``arrays``: the samples' ``[C+1, X, Y, Z]`` float32 C-contiguous
    arrays (memmaps included), each with the same C; ``origins [B, 3]``
    (negative or past the end: padding).  Returns (data ``[B, C, *patch]``
    float32, seg ``[B, *patch]`` int8)."""
    B = len(arrays)
    patch = np.ascontiguousarray(patch, dtype=np.int64)
    origins = np.ascontiguousarray(origins, dtype=np.int64).reshape(B, 3)
    if patch.shape != (3,):
        raise ValueError(f"the native gather takes a 3D patch, got {patch.tolist()}")
    n_mod = arrays[0].shape[0] - 1
    for a in arrays:
        if a.dtype != np.float32 or a.ndim != 4 or not a.flags.c_contiguous \
                or a.shape[0] - 1 != n_mod:
            raise ValueError(f"the native gather takes C-contiguous float32 [C+1, X, Y, Z] "
                             f"arrays with C={n_mod}, got {a.dtype} {a.shape}")
    lib = load()
    out_data = np.empty((B, n_mod, *patch), dtype=np.float32)
    out_seg = np.empty((B, *patch), dtype=np.int8)
    ptrs = (ctypes.c_void_p * B)(*[a.ctypes.data for a in arrays])
    shapes = np.ascontiguousarray([a.shape for a in arrays], dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(B, os.cpu_count() or 1)
    lib.gather_patches_cf(ptrs, _i64(shapes), _i64(origins), _i64(patch), B, n_threads,
                          out_data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out_seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out_data, out_seg
