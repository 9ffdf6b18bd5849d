"""ctypes binding of the native NIfTI / HDF5 reader (`native/mstio.cpp`,
`native/h5lite.cpp`).

Counterpart of `mst_tpu/data/native_io.py`. At first use `g++` builds the
two sources of `native/` with `native/Makefile`'s flags into
`build/mst_tpu_torch/libmstio_<hash>.so` (gitignored), named after a hash
of the sources and the flags, so a changed source rebuilds; the build runs
under a lock and lands by an atomic rename. It never runs `make` in
`native/` and never loads `native/libmstio.so`, the JAX package's build.
A failed build or load raises with the compiler's output: there is no
quiet fallback. The numpy reader (`utils.nifti.read_nifti`) is the plain
version, for the tests and for a read that asks for it.

  read_nifti(path)         -> (data [D, H, W] float32, affine [4, 4] f64)
  read_nifti_batch(paths)  -> a list of the same, decoded by a thread pool
  h5_read(path, name)      -> ndarray (float64 datasets as float64, else
                              float32), from an HDF5 file as h5py writes it
  h5_read_batch(items)     -> a list of ndarrays, decoded by a thread pool
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("mstio.cpp", "h5lite.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mst_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")
LD_FLAGS = ("-shared", "-lz", "-lpthread", "-ldl")

_lock = threading.Lock()
_lib = None


class _MstVolume(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("shape", ctypes.c_int64 * 3),
        ("affine", ctypes.c_double * 16),
        ("ok", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


class _H5Array(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("shape", ctypes.c_int64 * 8),
        ("rank", ctypes.c_int32),
        ("dtype", ctypes.c_int32),  # 0 = float32, 1 = float64
        ("ok", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


_CP = ctypes.c_char_p
_SIGNATURES = {
    "mstio_read_nifti": ((_CP, ctypes.POINTER(_MstVolume)), None),
    "mstio_read_batch": ((ctypes.POINTER(_CP), ctypes.c_int32,
                          ctypes.POINTER(_MstVolume), ctypes.c_int32), None),
    "mstio_free": ((ctypes.POINTER(ctypes.c_float),), None),
    "mstio_h5_read": ((_CP, _CP, ctypes.POINTER(_H5Array)), None),
    "mstio_h5_read_batch": ((ctypes.POINTER(_CP), ctypes.POINTER(_CP),
                             ctypes.c_int32, ctypes.POINTER(_H5Array),
                             ctypes.c_int32), None),
    "mstio_h5_free": ((ctypes.c_void_p,), None),
}


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libmstio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the reader if the library for the current sources is
    missing; return its path. Raises with the compiler's output on an
    error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS,
           *(str(NATIVE / s) for s in SOURCES), "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native reader failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded reader (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = handle
        return _lib


def _take(vol: _MstVolume, handle) -> Tuple[np.ndarray, np.ndarray]:
    shape = tuple(vol.shape)
    n = int(np.prod(shape))
    data = np.ctypeslib.as_array(vol.data, shape=(n,)).copy()
    handle.mstio_free(vol.data)
    return data.reshape(shape), np.asarray(vol.affine, np.float64).reshape(4, 4)


def _take_h5(arr: _H5Array, handle) -> np.ndarray:
    shape = tuple(arr.shape[:arr.rank])
    n = int(np.prod(shape)) if arr.rank else 1
    ct = ctypes.c_double if arr.dtype else ctypes.c_float
    data = np.ctypeslib.as_array((ct * n).from_address(arr.data)).copy()
    handle.mstio_h5_free(arr.data)
    return data.reshape(shape)


def _error(res) -> str:
    return res.error.decode(errors="replace")


def read_nifti(path) -> Tuple[np.ndarray, np.ndarray]:
    """-> (data [D, H, W] float32, affine). Raises IOError on failure."""
    handle = lib()
    vol = _MstVolume()
    handle.mstio_read_nifti(str(path).encode(), ctypes.byref(vol))
    if not vol.ok:
        raise IOError(f"{path}: {_error(vol)}")
    return _take(vol, handle)


def read_nifti_batch(paths: Sequence, num_threads: int = 4) -> List:
    """The volumes of `paths`, decoded by `num_threads` native threads.
    Every decoded buffer is taken (and freed) before the first failure
    raises, so a failed batch leaks nothing."""
    handle = lib()
    n = len(paths)
    vols = (_MstVolume * n)()
    c_paths = (_CP * n)(*[str(p).encode() for p in paths])
    handle.mstio_read_batch(c_paths, n, vols, num_threads)
    results, first_err = [], None
    for v, p in zip(vols, paths):
        if v.ok:
            results.append(_take(v, handle))
        elif first_err is None:
            first_err = IOError(f"{p}: {_error(v)}")
    if first_err is not None:
        raise first_err
    return results


def h5_read(path, name: str) -> np.ndarray:
    """HDF5 dataset `name` (a '/'-separated path) of `path`. Raises IOError
    on failure or on a format feature the reader does not take."""
    handle = lib()
    arr = _H5Array()
    handle.mstio_h5_read(str(path).encode(), name.encode(), ctypes.byref(arr))
    if not arr.ok:
        raise IOError(f"{path}:{name}: {_error(arr)}")
    return _take_h5(arr, handle)


def h5_read_batch(items: Sequence[Tuple], num_threads: int = 4) -> List:
    """(file, dataset) pairs, decoded by `num_threads` native threads; the
    first failure raises after every decoded buffer was taken."""
    handle = lib()
    n = len(items)
    arrs = (_H5Array * n)()
    c_paths = (_CP * n)(*[str(p).encode() for p, _ in items])
    c_names = (_CP * n)(*[str(d).encode() for _, d in items])
    handle.mstio_h5_read_batch(c_paths, c_names, n, arrs, num_threads)
    results, first_err = [], None
    for a, (p, d) in zip(arrs, items):
        if a.ok:
            results.append(_take_h5(a, handle))
        elif first_err is None:
            first_err = IOError(f"{p}:{d}: {_error(a)}")
    if first_err is not None:
        raise first_err
    return results
