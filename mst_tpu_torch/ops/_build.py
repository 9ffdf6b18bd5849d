"""Build and load the hand-written CUDA kernels (`mst_tpu_torch/csrc/*.cu`).

One `nvcc` per source compiles it to an object file, all of them started
together, and one more links the objects into a shared library with a
plain C interface, which is loaded with `ctypes` (pointers and the stream
as `c_void_p`, ints as `c_int`). The library lands in
`build/mst_tpu_torch/` at the repository root, named after a hash of the
sources, so a changed source rebuilds and an unchanged one is loaded as it
is. Nothing is built at import time: the first launch (or `build()`) does
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mst_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, ln_s, ln_b, w, bias, out, h_out|NULL, out2|NULL, M, K, N, eps, act,
    # stream
    "mst_ln_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # a, w, bias, ls|NULL, x, out, M, K, N, stream
    "mst_gemm_residual": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # qkv, out, lse|NULL, N, S, E, num_heads, scale, stream
    "mst_mhsa": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
    # a, w, bias, ls, g, gz, work, dls, M, K, N, stream
    "mst_gemm_dls": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # a, b, dw, db, work, M, K, N, rows_per_split, stream
    "mst_gemm_wgrad": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # dy, w, out, M, R, K, a|NULL, act, x|NULL, g, lns, eps, work, dlns,
    # dlnb, stream
    "mst_gemm_dgrad": (_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _F, _P,
                       _P, _P, _P),
    # qkv, o, dout, lse, delta, dqkv, N, S, E, num_heads, scale_log2, scale,
    # stream
    "mst_mhsa_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of mst_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmst_kernels_{h.hexdigest()[:16]}.so"


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(cmd, proc: subprocess.Popen, verbose: bool) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{log}")
    if verbose and log:
        print(log)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path. Raises on a compiler error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objdir = out.with_suffix(f".{os.getpid()}.obj")
    objdir.mkdir(exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [objdir / (s.stem + ".o") for s in srcs]
    ptxas = ["-Xptxas=-v"] if verbose else []
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiles = [[nvcc, *ptxas, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s),
                 "-o", str(o)] for s, o in zip(srcs, objs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
            str(tmp), *map(str, objs)]
    procs = []
    try:
        procs = [_start(cmd) for cmd in compiles]  # all at once
        for cmd, proc in zip(compiles, procs):
            _finish(cmd, proc, verbose)
        _finish(link, _start(link), verbose)
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(objdir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mst_error_string.argtypes = (_I,)
            handle.mst_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib().mst_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
