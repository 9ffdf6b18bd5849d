"""What the port's `tools/` experiments share: the card check, its tag line,
seeded inputs, CUDA-event timing, the head views of a packed qkv, and the
no-residual product of `csrc/gemm_residual.cu` (the experiments' products
that have no LayerNorm before them).

The wrappers of the experiments' kernels count their launches with the
package's others (`fused_block.register_wrappers`), so
`fused_block.reset_launch_counts()` / `launch_counts()` see them.
"""

from __future__ import annotations

import math
import statistics
import subprocess

import numpy as np
import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops.attention import _on_cuda

LOG2E = math.log2(math.e)
HD = 64  # head dim of every kernel here
TIMED_RUNS = 20


def require_cuda() -> torch.device:
    """The card the experiments run on; raises without one (there is no
    CPU path for an experiment)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the mst_tpu_torch.tools experiments run on a CUDA "
                           "device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def card_tag() -> str:
    """`[name, power limit]` as `nvidia-smi` reports them, for every line
    that carries a number."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return f"[{smi}]"


def time_ms(fn, n: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def normal(rng, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def codes(rng, shape) -> np.ndarray:
    """Uniform int8 codes in [-127, 127] (`jax.random.randint(.., -127,
    128)` of the JAX tools)."""
    return rng.integers(-127, 128, shape).astype(np.int8)


def tensor(arr, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def head_views(t, n: int, s: int, parts: int, num_heads: int):
    """The `parts` thirds of a packed [n*s, parts*E] tensor as [n, heads, s,
    64] views (q, k[, v])."""
    u = t.reshape(n, s, parts, num_heads, HD).permute(2, 0, 3, 1, 4)
    return tuple(u[i] for i in range(parts))


def merge_heads(o, n: int, s: int):
    """[n, heads, s, 64] -> [n*s, heads*64]."""
    return o.permute(0, 2, 1, 3).reshape(n * s, -1)


_ZEROS = {}


def _zeros(n: int, like) -> torch.Tensor:
    key = (n, like.device)
    if key not in _ZEROS:
        _ZEROS[key] = torch.zeros(n, dtype=torch.float32, device=like.device)
    return _ZEROS[key]


def gemm(a, w):
    """a @ w, rounded to a's dtype once, f32 accumulation: a [M, K], w [K,
    N]. On CUDA `gemm_residual.cu` without its residual (x = NULL) and with
    a zero bias."""
    if not _on_cuda(a):
        return fb._mm(a, w).to(a.dtype)
    m, k = a.shape
    n = w.shape[1]
    fb._check_residual_shape(m, k, n, "gemm")
    fb._mat(a, "a", (m, k), a)
    fb._mat(w, "w", (k, n), a)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _build.lib().mst_gemm_residual(
        a.data_ptr(), w.data_ptr(), _zeros(n, a).data_ptr(), None, None,
        out.data_ptr(), m, k, n, fb._stream(a))
    _build.check(err, "mst_gemm_residual (no residual)")
    gemm.launches += 1
    return out


def residual(a, w, x):
    """bf16(x + a @ w): `gemm_residual` with a zero bias and no
    LayerScale (the experiments' proj products have no bias)."""
    return fb.gemm_residual(a, w, _zeros(w.shape[1], x), None, x)


fb.register_wrappers(kernels=(gemm,))
