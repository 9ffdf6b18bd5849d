"""Fused ViT sub-layers on hand-written Hopper kernels.

Counterpart of `mst_tpu/ops/fused_block.py` (serving, plain flags):

- `fused_attention_sublayer`: y = x + ls1 * proj(MHSA(LN1(x)))
- `fused_mlp_sublayer`:       y = x + ls2 * fc2(gelu(fc1(LN2(x))))

On the TPU each is one Pallas program that keeps a slice's whole [S, E]
block and the layer's weights in VMEM. An H100 SM has 227 KB of shared
memory, so each sub-layer here is a short chain of CUDA kernels
(`mst_tpu_torch/csrc/`):

- attention: `ln_gemm` (LN + qkv) -> `mhsa` -> `gemm_residual` (proj + ls + x)
- MLP:       `ln_gemm` (LN + fc1 + GELU) -> `gemm_residual` (fc2 + ls + x)

Every kernel wrapper dispatches on the device of the tensor it is given: a
CUDA tensor launches the kernel (bf16 only) and counts the launch; a CPU
tensor takes the kernel's plain PyTorch version, which rounds to the
working dtype at the same points as the kernel and the Pallas body (qkv
after its bias, P before P.V, o / l, the GELU output, the residual sum in
f32). There is no fallback from one to the other.

Argument conventions follow the JAX package: x [N, S, E]; matrices in the
flax Dense layout [in, out]; LN scale / bias, biases and LayerScale as
vectors (used in f32); `ls=None` means no LayerScale.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops.attention import _on_cuda

_LOG2E = math.log2(math.e)

# Activation codes of `ln_gemm` (csrc/common.cuh `Act`).
ACT_NONE, ACT_GELU_TANH, ACT_GELU_ERF = 0, 1, 2


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _ln(x, scale, bias, eps=1e-6):
    """LayerNorm in f32 (two-pass statistics, as the Pallas bodies)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _gelu(x, approximate: bool):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _mm(a, b):
    """Product of working-dtype operands with f32 accumulation and an f32
    result (the kernels' and Pallas' `preferred_element_type=f32`)."""
    return torch.matmul(a.float(), b.float())


def _ln_gemm_ref(x, ln_s, ln_b, w, b, act: int, eps: float):
    h = _ln(x, ln_s, ln_b, eps).to(x.dtype)
    y = _mm(h, w) + b.float()
    if act != ACT_NONE:
        y = _gelu(y, act == ACT_GELU_TANH)
    return y.to(x.dtype)


def _mhsa_ref(qkv, n: int, s: int, num_heads: int):
    e = qkv.shape[1] // 3
    hd = e // num_heads
    dt = qkv.dtype
    t = qkv.reshape(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [n, heads, s, hd]
    sc = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd) * _LOG2E)
    p = torch.exp2(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = (_mm(p.to(dt), v) / l).to(dt)
    return o.permute(0, 2, 1, 3).reshape(n * s, e)


def _gemm_residual_ref(a, w, b, ls, x):
    y = _mm(a, w) + b.float()
    if ls is not None:
        y = y * ls.float()
    return (x.float() + y).to(x.dtype)


def _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
              eps=1e-6):
    n, s, e = x.shape
    dt = x.dtype
    x2 = x.reshape(n * s, e)
    qkv = _ln_gemm_ref(x2, ln_s, ln_b, wqkv.to(dt), bqkv, ACT_NONE, eps)
    o = _mhsa_ref(qkv, n, s, num_heads)
    return _gemm_residual_ref(o, wproj.to(dt), bproj, ls, x2).reshape(n, s, e)


def _mlp_ref(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate, eps=1e-6):
    n, s, e = x.shape
    dt = x.dtype
    x2 = x.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    h = _ln_gemm_ref(x2, ln_s, ln_b, w1.to(dt), b1, act, eps)
    return _gemm_residual_ref(h, w2.to(dt), b2, ls, x2).reshape(n, s, e)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _mat(t, name, shape, like):
    """Validate a bf16 operand of a CUDA kernel; raise on anything else."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name} requires grad: the CUDA kernels are forward-only (the "
            f"backward kernels are ROADMAP queue A #4); run under "
            f"torch.no_grad() or torch.inference_mode()")
    return t


def _vec(t, name, n, like):
    """A parameter vector as the kernels read it: [n] f32, contiguous, on
    the device of `like` (the JAX package's `_vec`)."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} elements, expected {n}")
    return t.detach().reshape(n).to(torch.float32).contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def ln_gemm(x, ln_s, ln_b, w, b, act: int, eps: float):
    """act(LN(x) @ w + b): x [M, K], w [K, N] -> [M, N]."""
    if not _on_cuda(x):
        return _ln_gemm_ref(x, ln_s, ln_b, w, b, act, eps)
    m, k = x.shape
    n = w.shape[1]
    if k % 32 or k > 1536 or n % 128:
        raise ValueError(f"ln_gemm needs K % 32 == 0, K <= 1536 and "
                         f"N % 128 == 0; got K={k}, N={n}")
    _mat(x, "x", (m, k), x)
    _mat(w, "w", (k, n), x)
    ln_s, ln_b = _vec(ln_s, "ln_s", k, x), _vec(ln_b, "ln_b", k, x)
    b = _vec(b, "bias", n, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _build.lib().mst_ln_gemm(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, k, n, float(eps), int(act),
        _stream(x))
    _build.check(err, "mst_ln_gemm")
    ln_gemm.launches += 1
    return out


def mhsa(qkv, n: int, s: int, num_heads: int):
    """Per-slice softmax attention: qkv [n*s, 3E] -> o [n*s, E]."""
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads)
    e = qkv.shape[1] // 3
    if e != 64 * num_heads or s > 512:
        raise ValueError(f"mhsa needs head dim 64 and S <= 512; got "
                         f"E={e}, heads={num_heads}, S={s}")
    _mat(qkv, "qkv", (n * s, 3 * e), qkv)
    out = torch.empty((n * s, e), dtype=qkv.dtype, device=qkv.device)
    err = _build.lib().mst_mhsa(
        qkv.data_ptr(), out.data_ptr(), n, s, e, num_heads,
        1.0 / math.sqrt(64) * _LOG2E, _stream(qkv))
    _build.check(err, "mst_mhsa")
    mhsa.launches += 1
    return out


def gemm_residual(a, w, b, ls, x):
    """x + ls * (a @ w + b): a [M, K], w [K, N], x [M, N] -> [M, N]."""
    if not _on_cuda(x):
        return _gemm_residual_ref(a, w, b, ls, x)
    m, k = a.shape
    n = w.shape[1]
    if k % 32 or n % 128:
        raise ValueError(f"gemm_residual needs K % 32 == 0 and N % 128 == 0;"
                         f" got K={k}, N={n}")
    _mat(a, "a", (m, k), x)
    _mat(w, "w", (k, n), x)
    _mat(x, "x", (m, n), x)
    b = _vec(b, "bias", n, x)
    ls = None if ls is None else _vec(ls, "ls", n, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _build.lib().mst_gemm_residual(
        a.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if ls is None else ls.data_ptr(), x.data_ptr(), out.data_ptr(),
        m, k, n, _stream(x))
    _build.check(err, "mst_gemm_residual")
    gemm_residual.launches += 1
    return out


def fused_attention_sublayer(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                             num_heads, eps=1e-6):
    """y = x + ls * proj(MHSA(LN(x))) for x [N, S, E]."""
    if not _on_cuda(x):
        return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                         num_heads, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = ln_gemm(x2, ln_s, ln_b, wqkv, bqkv, ACT_NONE, eps)
    o = mhsa(qkv, n, s, num_heads)
    y = gemm_residual(o, wproj, bproj, ls, x2)
    fused_attention_sublayer.calls += 1
    return y.reshape(n, s, e)


def fused_mlp_sublayer(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                       eps=1e-6):
    """y = x + ls * fc2(gelu(fc1(LN(x)))) for x [N, S, E]."""
    if not _on_cuda(x):
        return _mlp_ref(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    h = ln_gemm(x2, ln_s, ln_b, w1, b1, act, eps)
    y = gemm_residual(h, w2, b2, ls, x2)
    fused_mlp_sublayer.calls += 1
    return y.reshape(n, s, e)


# `.launches` of a kernel wrapper counts its kernel's launches; `.calls` of a
# sub-layer counts the calls that ran its kernel chain (it launches nothing
# itself). Neither moves on the CPU path.
KERNEL_WRAPPERS = (ln_gemm, mhsa, gemm_residual)
SUBLAYER_WRAPPERS = (fused_attention_sublayer, fused_mlp_sublayer)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in SUBLAYER_WRAPPERS:
        fn.calls = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def sublayer_calls() -> dict:
    return {fn.__name__: fn.calls for fn in SUBLAYER_WRAPPERS}


reset_launch_counts()
