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
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, ln_s, ln_b, h, M, K, eps, stream
    "mst_ln_rows": (_P, _P, _P, _P, _I, _I, _F, _P),
    # h, w, bias, out, out2|NULL, M, K, N, act, stream
    "mst_gemm_act": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # h, w12, b12, out, h12|NULL, M, K, F, stream
    "mst_gemm_swiglu": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # M, K, N, gated, geo (host int32 [5])
    "mst_gemm_geometry": (_I, _I, _I, _I, _P),
    # a, w, bias, ls|NULL, x|NULL, out, M, K, N, stream
    "mst_gemm_residual": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # M, K, N, geo (host int32 [6]): gemm_residual's and gemm_dls's launch
    "mst_residual_geometry": (_I, _I, _I, _P),
    # qkv, out, lse|NULL, row|NULL, carry|NULL, carry_part, new_carry,
    # abnar|NULL, rope_cos|NULL, rope_sin|NULL, N, S, E, num_heads, scale,
    # stream
    "mst_mhsa": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                 _P),
    # S, geo (host int32 [10]): mst_mhsa's launch geometry
    "mst_mhsa_geometry": (_I, _P),
    # S, geo (host int32 [7]): mst_mhsa_bwd's launch geometry
    "mst_mhsa_bwd_geometry": (_I, _P),
    # a, w, bias, ls, g, gz, work, dls, M, K, N, stream
    "mst_gemm_dls": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # a, b, dw, db, work, work_bytes, M, K, N, stream
    "mst_gemm_wgrad": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    # M, K, N, geo (host int64 [8])
    "mst_wgrad_geometry": (_I, _I, _I, _P),
    # dy, w, out, a|NULL, M, R, K, mode, act, stream
    "mst_gemm_dgrad": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # M, R, K, geo (host int64 [8])
    "mst_dgrad_geometry": (_I, _I, _I, _P),
    # a, b, c (f32), M, N, K, layout, swap, stream: the layout probes
    "mst_gemm_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # dh (f32), x, g, lns, eps, out, work, work_bytes, dlns, dlnb, M, K,
    # stream
    "mst_ln_pullback": (_P, _P, _P, _P, _F, _P, _P, _L, _P, _P, _I, _I, _P),
    # M, K, geo (host int64 [8]): mst_ln_pullback's launch geometry
    "mst_ln_pullback_geometry": (_I, _I, _P),
    # qkv, o, dout, lse, delta, dqkv, rope_cos|NULL, rope_sin|NULL, N, S, E,
    # num_heads, scale_log2, scale, stream
    "mst_mhsa_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                     _P),
    # x, ln_s, ln_b, q (int8), scale|NULL, M, K, eps, stream
    "mst_ln_quant_rows": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    # a (int8), wt (int8 [N, K]), row_scale|NULL, scale, bias, a_inv|NULL,
    # out, out_mode, M, K, N, act, stream
    "mst_gemm_i8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # a (int8), wt (int8 [2F, K]), row_scale|NULL, scale, bias, a_inv|NULL,
    # out, out_mode, M, K, F, stream
    "mst_gemm_i8_swiglu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # M, K, N, gated, geo (host int32 [8]): the int8 GEMM's launch geometry
    "mst_gemm_i8_geometry": (_I, _I, _I, _I, _P),
    # a, b (int8), c (int32), M, N, K, swap, stream: the int8 layout probe
    "mst_gemm_i8_probe": (_P, _P, _P, _I, _I, _I, _I, _P),
    # src, is_f32, q, scale|NULL, M, K, sms, stream
    "mst_quant_rows": (_P, _I, _P, _P, _I, _I, _I, _P),
    # M, K, is_f32, is_static, sms, geo (host int32 [12]): quant_rows's
    # launch plan
    "mst_quant_rows_geometry": (_I, _I, _I, _I, _I, _P),
    # a (int8), wt (int8 [N, K]), row_scale|NULL, scale, bias, ls|NULL, x,
    # out, M, K, N, stream
    "mst_gemm_i8_residual": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # M, K, N, geo (host int32 [7]): gemm_i8_residual's launch geometry
    "mst_i8_residual_geometry": (_I, _I, _I, _P),
    # q, k, v, o, lse|NULL, strides (host int64 [4][3]), B, H, S, scale_log2,
    # stream
    "mst_flash_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, k, v, o, do, lse, delta, dq, strides ([6][3]), B, H, S, scale_log2,
    # sm_scale, stream
    "mst_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                         _F, _P),
    # q, k, v, do, lse, delta, dk, dv, strides ([6][3]), B, H, S, scale_log2,
    # sm_scale, stream
    "mst_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _F, _P),
    # B, H, S, part (0 fwd, 1 dq, 2 dkv), geo (host int32 [9]): the flash
    # kernels' launch geometry
    "mst_flash_geometry": (_I, _I, _I, _I, _P),
    # q, k, lse, carry|NULL, out, strides (host int64 [2][3]), B, H, S,
    # scale_log2, row (the CLS-row form), stream
    "mst_flash_carry": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, lse, out ([B, S] f32: the Abnar row normaliser), strides ([2][3]),
    # B, H, S, scale_log2, stream
    "mst_flash_abnar": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # B, H, S, part (0 row, 1 carry, 2 abnar), geo (host int32 [9]): the
    # saliency kernels' launch geometry
    "mst_flash_sal_geometry": (_I, _I, _I, _I, _P),
    # the tools/ experiments (mst_tpu_torch/tools/), queue B rows 17-21:
    # qkv, out, p_out|NULL, N, S, E, num_heads, variant, scale, stream
    "mst_attn_variant": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # S, geo (host int32 [8]): mst_attn_variant's launch geometry
    "mst_attn_variant_geometry": (_I, _P),
    # qkv, out, N, S, E, num_heads, scale, stream
    "mst_attn_split_cls": (_P, _P, _I, _I, _I, _I, _F, _P),
    # S, geo (host int32 [7]): mst_attn_split_cls's launch geometry
    "mst_attn_split_cls_geometry": (_I, _P),
    # codes (int8), v|NULL, out, p_out|NULL, N, S, E, num_heads, variant,
    # scale, stream
    "mst_attn_i8": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # S, variant, geo (host int32 [9]): mst_attn_i8's launch geometry
    "mst_attn_i8_geometry": (_I, _I, _P),
    # o, x, wproj, bproj, ln_s, ln_b, w1, b1, w2, b2, out, M, E, F, eps,
    # stream
    "mst_block_tail": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _P),
    # M, SMs, geo (host int32 [9]): mst_block_tail's launch geometry
    "mst_block_tail_geometry": (_I, _I, _P),
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


def ptxas_log(name: str) -> str:
    """`-Xptxas -v` (registers, stack, spills per kernel) of one source,
    `csrc/<name>`, compiled on its own with the library's flags; the
    object is thrown away."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"{Path(name).stem}.{os.getpid()}.ptxas.o"
    cmd = [_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-I", str(CSRC), "-c",
           str(CSRC / name), "-o", str(obj)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    finally:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


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
