"""W8A8 int8 serving sub-layers on hand-written Hopper kernels.

Counterpart of `mst_tpu/ops/fused_int8.py` (which imports JAX, so the port
keeps its own copy of the recipe). The token-wise products of an encoder
block (qkv / proj, fc1 / fc2 or w12 / w3) run as int8 x int8 -> int32 with

- per-output-channel symmetric weight scales (`quantize_weight_int8`, from
  the f32 master weights), and
- per-token symmetric activation scales computed after the LayerNorm
  (dynamic), or per-tensor scales calibrated on real volumes
  (`calibrate_act_scales_int8`) and folded offline into the LN, the
  dequantization scales and the v-columns (static, `_fold_static_scales`),
  so that only the FFN's nonlinear hidden needs a runtime multiply
  (`a_inv`);

while softmax attention stays in bf16 on the dequantized q / k / v (the
existing `mhsa` kernel with its RoPE / CLS-row / rollout-carry / Abnar
forms), and the patch embed, slice fusion and head stay full precision.

On the TPU each sub-layer is one Pallas program (`_attn_i8_kernel`,
`_mlp_i8_kernel`, `_swiglu_i8_kernel`); here it is a chain of CUDA kernels
(`mst_tpu_torch/csrc/`):

- attention: `ln_gemm_i8` (LN + quantize + qkv, bf16 out) -> `mhsa` ->
  `quant_rows` (o) -> `gemm_i8_residual` (proj + ls + x)
- MLP:       `ln_gemm_i8` (LN + quantize + fc1 + GELU; f32 out, or int8 for
  a static tree) -> [`quant_rows` (dynamic)] -> `gemm_i8_residual` (fc2)
- SwiGLU:    `ln_gemm_i8_swiglu` (LN + quantize + w12 + SiLU gate) ->
  [`quant_rows`] -> `gemm_i8_residual` (w3)

`ln_gemm_i8` and `ln_gemm_i8_swiglu` are two kernels each: `ln_quant_rows`
(LN and quantization once per row: the codes and, dynamic, the row scales)
then an int8 TMA + wgmma GEMM on the codes with the dequantization
epilogues. `gemm_i8_residual` runs the same int8 GEMM with the
dequantization, LayerScale and residual epilogue. 8-bit wgmma reads both
operands K-major, so both GEMMs read the weights as `q8t` [out, in], the
K-major copy of `q8` that every `QDense` makes once, when the int8 tree is
built. `quant_rows` reads each row once: persistent blocks stage whole rows
in shared memory by TMA bulk copies on an `mbarrier` ring, take the row's
amax from the staged copy, then write its codes.

Every kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel (counting the launch) for a CUDA tensor. The plain
versions round where the kernels and the Pallas bodies round: LN in f32,
the codes by round-half-to-even of h times the reciprocal scale (dynamic)
or clip(round(h), +-127) (static), the exact integer product (in f64, which
holds every partial sum: |sum| <= K * 127^2 < 2^53), dequantization as
f32(acc) [* row scale] * col scale + bias, qkv rounded to the working dtype
before `mhsa`, o quantized from that rounded value, the FFN hidden from the
f32 value, the residual sum in f32. Like `fused_block._f` they keep f64
when given f64.

The tree side (`quantize_encoder_int8`, `calibrate_act_scales_int8`,
`quantize_mst_int8`) returns a quantized copy of the model: each quantized
Dense becomes a `models.layers.QDense` holding `q8` int8 [in, out],
`scale` f32 [1, out], `bias` f32 [out] and, on fc2 / w3 of a static tree,
`a_inv` f32 [1, 1]; `Block.forward` dispatches on it. The last block stays
unquantized by default (`quantize_last=False`): serving runs it through the
CLS-only plain block.
"""

from __future__ import annotations

import copy
import logging
import math
from types import SimpleNamespace
from typing import Optional

import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops.attention import _on_cuda, exporting
from mst_tpu_torch.ops.fused_block import (
    ACT_GELU_ERF,
    ACT_GELU_TANH,
    ACT_NONE,
    _called,
    _f,
    _f32,
    _gelu,
    _ln,
    _mat,
    _mhsa_ref,
    _ptr,
    _rows,
    _stream,
    _vec,
    mhsa,
    mhsa_abnar,
    mhsa_rollout,
    mhsa_with_row,
)
from mst_tpu_torch.ops.rotary import apply_rope_tables

log = logging.getLogger(__name__)

# Output modes of `ln_gemm_i8` (csrc/ln_gemm_i8.cu `OutMode`).
OUT_BF16, OUT_F32, OUT_I8 = 0, 1, 2
_INV127 = 1.0 / 127.0


# ---------------------------------------------------------------------------
# Quantization and the plain versions
# ---------------------------------------------------------------------------


def quantize_weight_int8(w):
    """[E, F] weight -> (int8 [E, F], f32 per-output-channel scale [1, F]):
    s = max(max_k |w[k, f]| * f32(1/127), 1e-12) (XLA turns the JAX body's
    division by the constant 127 into this product), q = clip(round(w /
    s), +-127), from the f32 values."""
    w = w.detach().float()
    s = torch.clamp_min(w.abs().amax(0, keepdim=True) * _INV127, 1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def _quant_rows(h):
    """Per-token symmetric quantization of h [T, F] -> (int8 codes, scale
    [T]): scale = max(amax, 1e-12) * (1/127), q = round(h * (1/scale))."""
    amax = h.abs().amax(-1, keepdim=True)
    scale = amax.clamp_min(1e-12) * _INV127
    q = torch.round(h * torch.reciprocal(scale)).to(torch.int8)
    return q, scale[..., 0]


def _quant_static(h):
    """Static quantization of a pre-scaled h: clip(round(h), +-127)."""
    return torch.clamp(torch.round(h), -127, 127).to(torch.int8)


def _dot_i8(a, w):
    """The exact integer product of int8 a [T, K] and w [K, F], in f64."""
    return torch.matmul(a.double(), w.double())


def _wd(dtype):
    """The working precision of the plain versions on inputs of `dtype`:
    f32, or f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _dequant(acc, wd, row_scale, scale, bias):
    """f32(acc) [* row scale] * col scale + bias, in that order."""
    v = acc.to(wd)
    if row_scale is not None:
        v = v * row_scale.to(wd)[:, None]
    return v * scale.to(wd).reshape(-1) + bias.to(wd).reshape(-1)


def _quantize_ln(x, ln_s, ln_b, eps, static: bool = False):
    """LN(x) quantized: (codes, row scale [T] | None for static)."""
    h = _ln(x, ln_s, ln_b, eps)
    return (_quant_static(h), None) if static else _quant_rows(h)


def _ln_gemm_i8_ref(x, ln_s, ln_b, q8, scale, bias, act: int, eps: float,
                    static: bool = False, a_inv=None, q8t=None):
    """act(dequant(quant(LN(x)) @ q8)): ACT_NONE without `a_inv` -> in x's
    dtype (qkv); a GELU, or ACT_NONE with `a_inv` (the identity) -> its f32
    value (dynamic) or clip(round(u * a_inv)) int8 (static). It takes its
    wrapper's arguments; `q8t`, the kernel's K-major copy, is not read."""
    wd = _wd(x.dtype)
    hq, hs = _quantize_ln(x, ln_s, ln_b, eps, static)
    v = _dequant(_dot_i8(hq, q8), wd, hs, scale, bias)
    if act == ACT_NONE and a_inv is None:
        return v.to(x.dtype)
    u = v if act == ACT_NONE else _gelu(v, act == ACT_GELU_TANH)
    return _quant_static(u * a_inv.to(wd).reshape(())) if static else u


def _ln_gemm_i8_swiglu_ref(x, ln_s, ln_b, q8, scale, bias, eps: float,
                           static: bool = False, a_inv=None, q8t=None):
    """g = silu(h1) * h2 on the f32 dequantized [h1 | h2]: f32 (dynamic)
    or clip(round(g * a_inv)) int8 (static); `q8t` is not read."""
    wd = _wd(x.dtype)
    hq, hs = _quantize_ln(x, ln_s, ln_b, eps, static)
    h1, h2 = _dequant(_dot_i8(hq, q8), wd, hs, scale, bias).chunk(2, dim=-1)
    g = h1 * torch.sigmoid(h1) * h2
    return _quant_static(g * a_inv.to(wd).reshape(())) if static else g


def _gemm_i8_ref(hq, hs, q8t, scale, bias, act: int, dtype,
                 static: bool = False, a_inv=None):
    """The GEMM half of `ln_gemm_i8` on its codes: hq [M, K] int8 with row
    scale hs [M] (None: static) against the K-major weights q8t [N, K] ->
    act(dequant(hq @ q8t^T)), rounded and returned as `_ln_gemm_i8_ref`
    does (`dtype`: the input's)."""
    wd = _wd(dtype)
    v = _dequant(_dot_i8(hq, q8t.t()), wd, hs, scale, bias)
    if act == ACT_NONE and a_inv is None:
        return v.to(dtype)
    u = v if act == ACT_NONE else _gelu(v, act == ACT_GELU_TANH)
    return _quant_static(u * a_inv.to(wd).reshape(())) if static else u


def _gemm_i8_swiglu_ref(hq, hs, q8t, scale, bias, dtype, static: bool = False,
                        a_inv=None):
    """The GEMM half of `ln_gemm_i8_swiglu` on its codes against the
    K-major w12^T [2F, K]: g = silu(h1) * h2 as `_ln_gemm_i8_swiglu_ref`."""
    wd = _wd(dtype)
    h1, h2 = _dequant(_dot_i8(hq, q8t.t()), wd, hs, scale, bias).chunk(2, -1)
    g = h1 * torch.sigmoid(h1) * h2
    return _quant_static(g * a_inv.to(wd).reshape(())) if static else g


def _quant_rows_ref(v, static: bool = False):
    """(codes, row scale [T]) of v (dynamic), or its static codes."""
    vf = _f(v)
    return _quant_static(vf) if static else _quant_rows(vf)


def _gemm_i8_residual_ref(a, row_scale, q8, scale, bias, ls, x, q8t=None):
    """x + ls * dequant(a @ q8), the sum in f32, cast to x's dtype. It takes
    its wrapper's arguments; `q8t`, the kernel's K-major copy, is not
    read."""
    wd = _wd(x.dtype)
    y = _dequant(_dot_i8(a, q8), wd, row_scale, scale, bias)
    if ls is not None:
        y = y * ls.to(wd)
    return (_f(x) + y).to(x.dtype)


def _check_flags(want_row, carry, abnar):
    if abnar and (want_row or carry is not None):
        raise ValueError("the Abnar factor is a saliency mode of its own: "
                         "not with want_row or carry")


def _attn_i8_ref(x, ln_s, ln_b, qkv, proj, ls, num_heads, eps=1e-6,
                 rope_cos=None, rope_sin=None, static=False, want_row=False,
                 carry=None, abnar=False):
    """The int8 attention sub-layer (`_attn_i8_kernel`); `qkv` / `proj`:
    `QDense`s. Returns y, or (y, [row], [abnar factor], [carry])."""
    _check_flags(want_row, carry, abnar)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    t = _ln_gemm_i8_ref(x2, ln_s, ln_b, qkv.q8, qkv.scale, qkv.bias,
                        ACT_NONE, eps, static)
    out = _mhsa_ref(t, n, s, num_heads, want_row=want_row, carry=carry,
                    want_abnar=abnar, rope_cos=rope_cos, rope_sin=rope_sin)
    o, extra = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
    oq, osc = ((_quant_rows_ref(o, True), None) if static
               else _quant_rows_ref(o))
    y = _gemm_i8_residual_ref(oq, osc, proj.q8, proj.scale, proj.bias, ls,
                              x2).reshape(n, s, e)
    return (y, *extra) if extra else y


def _mlp_i8_ref(x, ln_s, ln_b, fc1, fc2, ls, approximate, eps=1e-6):
    """The int8 MLP sub-layer (`_mlp_i8_kernel`); static when fc2 carries
    `a_inv`."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    static = fc2.a_inv is not None
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    u = _ln_gemm_i8_ref(x2, ln_s, ln_b, fc1.q8, fc1.scale, fc1.bias, act,
                        eps, static, fc2.a_inv)
    uq, us = (u, None) if static else _quant_rows_ref(u)
    return _gemm_i8_residual_ref(uq, us, fc2.q8, fc2.scale, fc2.bias, ls,
                                 x2).reshape(n, s, e)


def _swiglu_i8_ref(x, ln_s, ln_b, w12, w3, ls, eps=1e-6):
    """The int8 SwiGLU sub-layer (`_swiglu_i8_kernel`); static when w3
    carries `a_inv`."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    static = w3.a_inv is not None
    g = _ln_gemm_i8_swiglu_ref(x2, ln_s, ln_b, w12.q8, w12.scale, w12.bias,
                               eps, static, w3.a_inv)
    gq, gs = (g, None) if static else _quant_rows_ref(g)
    return _gemm_i8_residual_ref(gq, gs, w3.q8, w3.scale, w3.bias, ls,
                                 x2).reshape(n, s, e)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _codes(t, name, shape, like):
    """Validate int8 codes for a CUDA kernel; raise on anything else."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != torch.int8:
        raise TypeError(f"{name} must be int8 codes, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return t


def _row_scale(t, m, like):
    """A per-row scale [m] f32 as the kernels read it, or None (static)."""
    if t is None:
        return None
    if (t.dtype != torch.float32 or tuple(t.shape) != (m,)
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"row_scale must be contiguous f32 {(m,)} on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)}")
    return t


# The int8 GEMM (csrc/ln_gemm_i8.cu on gemm_sm90.cuh): 128 x 128 output
# tiles (gated: 64 gate columns, whose h1 and h2 panels of w12^T make the
# 128 W rows of a tile), k in stages of 128; `ln_quant_rows` holds a row of
# at most 4096 in registers, 8 rows a block.
I8_BK, I8_MAX_K, _QR_ROWS = 128, 4096, 8


def _check_i8_shape(m: int, k: int, n: int, gated: bool) -> None:
    """Raise ValueError for an x [m, k] -> n (gated: n = F) that
    `ln_gemm_i8` / `ln_gemm_i8_swiglu` do not take; the wrappers call it
    before any launch."""
    bn = fb.GEMM_BN // 2 if gated else fb.GEMM_BN
    if (m < 1 or k < I8_BK or k % I8_BK or k > I8_MAX_K or n < bn
            or n % bn):
        name, width = (("ln_gemm_i8_swiglu", "F") if gated
                       else ("ln_gemm_i8", "N"))
        raise ValueError(f"{name} needs M >= 1, K % {I8_BK} == 0, K <= "
                         f"{I8_MAX_K} and {width} % {bn} == 0; got M={m}, "
                         f"K={k}, {width}={n}")


def ln_gemm_i8_launch(m: int, k: int, n: int, gated: bool = False,
                      sms: int = fb.H100_SMS) -> SimpleNamespace:
    """The launch geometry of `ln_gemm_i8`'s GEMM (`gated`:
    `ln_gemm_i8_swiglu`'s, n = F) at codes [m, k] on a card of `sms` SMs
    (csrc/ln_gemm_i8.cu `mst_gemm_i8_geometry`): tiles, grid, threads,
    stages, dynamic shared memory, k tiles, the first W^T row of tile 0's
    second box (gated: F, its h2 panel; else 64) and `ln_quant_rows`'s
    blocks. Raises ValueError where the kernels would."""
    _check_i8_shape(m, k, n, gated)
    tiles = -(-m // fb.GEMM_BM) * (n // (fb.GEMM_BN // 2 if gated
                                         else fb.GEMM_BN))
    return SimpleNamespace(tiles=tiles, grid=min(tiles, sms),
                           threads=fb.GEMM_THREADS, stages=fb.GEMM_STAGES,
                           smem=fb.GEMM_SMEM, k_tiles=k // I8_BK,
                           second_box=n if gated else 64,
                           quant_blocks=-(-m // _QR_ROWS))


def _kmajor(q8, q8t, n, k, like, name):
    """The K-major weights [n, k] int8 the GEMM reads (`QDense.q8t`)."""
    if q8t is None:
        raise ValueError(f"{name} on CUDA needs q8t, the K-major [out, in] "
                         f"copy of q8 that QDense holds")
    if tuple(q8.shape) != (k, n):
        raise ValueError(f"q8 has shape {tuple(q8.shape)}, expected {(k, n)}")
    return _codes(q8t, "q8t", (n, k), like)


def _need_q8t(q8t, name):
    if q8t is None:
        raise ValueError(f"{name} through its registered op needs q8t, the "
                         f"K-major [out, in] copy of q8 that QDense holds")
    return q8t


def _gemm_i8_via_ops(x, ln_s, ln_b, q8, q8t, scale, bias, act, eps, static,
                     a_inv, gated: bool):
    """`ln_gemm_i8` / `ln_gemm_i8_swiglu` through the registered ops:
    `ln_quant_rows`, then `gemm_i8` on the codes and K-major weights."""
    name = "ln_gemm_i8_swiglu" if gated else "ln_gemm_i8"
    q8t = _need_q8t(q8t, name)
    hq, hs = ln_quant_rows(x, ln_s, ln_b, eps, static)
    return _gemm_i8_op(hq, hs, q8t, scale, bias, a_inv, int(act), gated,
                       x.dtype)


def _ln_i8_args(x, ln_s, ln_b, scale, bias, n):
    """The checked vectors of the two `ln_gemm_i8` modes."""
    k = x.shape[1]
    return (_vec(ln_s, "ln_s", k, x), _vec(ln_b, "ln_b", k, x),
            _vec(scale, "scale", n, x), _vec(bias, "bias", n, x))


def _out_mode(static, a_inv, like):
    """(mode, a_inv on the device | None) of an FFN first half."""
    if not static:
        return OUT_F32, None
    if a_inv is None:
        raise ValueError("a static FFN hidden needs a_inv")
    return OUT_I8, _vec(a_inv, "a_inv", 1, like)


def ln_quant_rows(x, ln_s, ln_b, eps: float, static: bool = False):
    """LN(x) quantized once per row, the first kernel of `ln_gemm_i8` and
    `ln_gemm_i8_swiglu`: x [M, K] bf16 -> (int8 codes [M, K], row scale [M]
    f32), or with `static` (codes, None)."""
    if exporting():
        q, *hs = _ln_quant_rows_op(x, ln_s, ln_b, float(eps), static)
        return q, (hs[0] if hs else None)
    if not _on_cuda(x):
        return _quantize_ln(x, ln_s, ln_b, eps, static)
    return _ln_quant_rows_cuda(x, ln_s, ln_b, eps, static)


def _ln_quant_rows_cuda(x, ln_s, ln_b, eps: float, static: bool):
    m, k = x.shape
    if m < 1 or k < 8 or k % 8 or k > I8_MAX_K:
        raise ValueError(f"ln_quant_rows needs M >= 1, K % 8 == 0 and K <= "
                         f"{I8_MAX_K}; got M={m}, K={k}")
    _mat(x, "x", (m, k), x)
    ln_s, ln_b = _vec(ln_s, "ln_s", k, x), _vec(ln_b, "ln_b", k, x)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    hs = None if static else _f32((m,), x)
    err = _build.lib().mst_ln_quant_rows(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), q.data_ptr(),
        _ptr(hs), m, k, float(eps), _stream(x))
    _build.check(err, "mst_ln_quant_rows")
    ln_quant_rows.launches += 1
    return q, hs


def _gemm_i8(hq, hs, q8t, scale, bias, ainv, out, mode: int, act: int,
             gated: bool) -> None:
    """Launch the int8 GEMM on checked operands: codes hq [M, K], row scale
    hs [M] | None, q8t [N, K] (gated: [2F, K]) into `out` (not counted:
    `ln_gemm_i8` / `ln_gemm_i8_swiglu` count their calls)."""
    m, k = hq.shape
    n = out.shape[1]
    lib = _build.lib()
    args = (hq.data_ptr(), q8t.data_ptr(), _ptr(hs), scale.data_ptr(),
            bias.data_ptr(), _ptr(ainv), out.data_ptr(), mode, m, k, n)
    if gated:
        _build.check(lib.mst_gemm_i8_swiglu(*args, _stream(out)),
                     "mst_gemm_i8_swiglu")
    else:
        _build.check(lib.mst_gemm_i8(*args, int(act), _stream(out)),
                     "mst_gemm_i8")


def ln_gemm_i8(x, ln_s, ln_b, q8, scale, bias, act: int, eps: float,
               static: bool = False, a_inv=None, q8t=None):
    """x [M, K] bf16, q8 [K, N] int8 -> act(dequant(quant(LN(x)) @ q8)):
    bf16 for ACT_NONE (the qkv), the f32 GELU output (dynamic), or its
    static int8 codes clip(round(u * a_inv)) [M, N]; ACT_NONE with `a_inv`
    takes the identity for the GELU, so a static call gives the qkv's own
    codes (the int8 attention experiments,
    `mst_tpu_torch.tools.bench_attn_i8`). On CUDA the GEMM reads `q8t`
    [N, K], the K-major copy of q8 (`QDense.q8t`)."""
    if exporting():
        return _gemm_i8_via_ops(x, ln_s, ln_b, q8, q8t, scale, bias, act,
                                eps, static, a_inv, False)
    if not _on_cuda(x):
        return _ln_gemm_i8_ref(x, ln_s, ln_b, q8, scale, bias, act, eps,
                               static, a_inv)
    m, k = x.shape
    n = q8.shape[1]
    _check_i8_shape(m, k, n, False)
    _mat(x, "x", (m, k), x)
    q8t = _kmajor(q8, q8t, n, k, x, "ln_gemm_i8")
    ln_s, ln_b, scale, bias = _ln_i8_args(x, ln_s, ln_b, scale, bias, n)
    if act == ACT_NONE and a_inv is None:
        mode, ainv = OUT_BF16, None
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    else:
        mode, ainv = _out_mode(static, a_inv, x)
        out = torch.empty((m, n), device=x.device, dtype=torch.int8
                          if mode == OUT_I8 else torch.float32)
    hq, hs = ln_quant_rows(x, ln_s, ln_b, eps, static)
    _gemm_i8(hq, hs, q8t, scale, bias, ainv, out, mode, act, False)
    ln_gemm_i8.launches += 1
    return out


def ln_gemm_i8_swiglu(x, ln_s, ln_b, q8, scale, bias, eps: float,
                      static: bool = False, a_inv=None, q8t=None):
    """The gated int8 first half: x [M, K] bf16, q8 = w12 [K, 2F] int8 ->
    g = silu(h1) * h2 [M, F] in f32 (dynamic) or its static int8 codes. On
    CUDA the GEMM reads `q8t` = w12^T [2F, K] (`QDense.q8t`)."""
    if exporting():
        return _gemm_i8_via_ops(x, ln_s, ln_b, q8, q8t, scale, bias,
                                ACT_NONE, eps, static, a_inv, True)
    if not _on_cuda(x):
        return _ln_gemm_i8_swiglu_ref(x, ln_s, ln_b, q8, scale, bias, eps,
                                      static, a_inv)
    m, k = x.shape
    f2 = q8.shape[1]
    if f2 % 2:
        raise ValueError(f"ln_gemm_i8_swiglu needs an even w12 width; got "
                         f"{f2}")
    _check_i8_shape(m, k, f2 // 2, True)
    _mat(x, "x", (m, k), x)
    q8t = _kmajor(q8, q8t, f2, k, x, "ln_gemm_i8_swiglu")
    ln_s, ln_b, scale, bias = _ln_i8_args(x, ln_s, ln_b, scale, bias, f2)
    mode, ainv = _out_mode(static, a_inv, x)
    out = torch.empty((m, f2 // 2), device=x.device, dtype=torch.int8
                      if mode == OUT_I8 else torch.float32)
    hq, hs = ln_quant_rows(x, ln_s, ln_b, eps, static)
    _gemm_i8(hq, hs, q8t, scale, bias, ainv, out, mode, ACT_NONE, True)
    ln_gemm_i8_swiglu.launches += 1
    return out


# `quant_rows` (csrc/quant_rows.cu): a ring of QR_STAGES stages of QR_STAGE
# bytes filled by 1D TMA bulk copies, QR_BLOCKS_PER_SM persistent blocks an
# SM of QR_WARPS consumer warps and one producer warp; a group of at most
# QR_MAX_ROWS rows a stage.
QR_STAGE, QR_STAGES, QR_WARPS, QR_BLOCKS_PER_SM = 32768, 3, 8, 2
QR_MAX_ROWS = 16
_QR_THREADS = 32 * QR_WARPS + 32
_QR_SMEM = (QR_STAGE * QR_STAGES + 2 * QR_STAGES * 8 + 2 * QR_WARPS * 4
            + 2 * QR_MAX_ROWS * 4)


def quant_rows_launch(m: int, k: int, sms: int = fb.H100_SMS,
                      dtype=torch.float32,
                      static: bool = False) -> SimpleNamespace:
    """The launch plan of `quant_rows` at v [m, k] of `dtype` (bf16 or f32)
    on a card of `sms` SMs (csrc/quant_rows.cu `mst_quant_rows_geometry`):
    a group is `rows` consecutive rows of at most one stage, or one row of
    `chunks` stages, read by one bulk copy a stage; `streamed` rows are
    wider than the ring and go through it chunk by chunk, `passes` times
    (twice in the dynamic mode: amax, then codes); `wpr` warps take a row;
    `grid` persistent blocks walk over the `groups`; a thread quantizes
    `vec` values at a time. Raises ValueError where the kernel would."""
    if m < 1 or k < 8 or k % 8 or sms < 1:
        raise ValueError(f"quant_rows needs M >= 1 and K % 8 == 0; got M={m}, "
                         f"K={k}")
    vec = 16 if k % 16 == 0 else 8
    rb = k * (4 if dtype == torch.float32 else 2)
    if rb <= QR_STAGE:
        rows, chunks = min(QR_STAGE // rb, QR_MAX_ROWS, m), 1
    else:
        rows, chunks = 1, -(-rb // QR_STAGE)
    streamed = chunks > QR_STAGES
    wpr = QR_WARPS
    if not streamed:  # the busiest warp's fewest vector steps, fewest warps
        vpr, best = k // vec, None
        for w in (1, 2, 4, 8):
            teams = QR_WARPS // w
            steps = -(-rows // teams) * -(-vpr // (32 * w))
            if best is None or steps < best:
                best, wpr = steps, w
    groups = -(-m // rows)
    return SimpleNamespace(grid=min(groups, sms * QR_BLOCKS_PER_SM),
                           threads=_QR_THREADS, smem=_QR_SMEM, rows=rows,
                           chunks=chunks,
                           passes=2 if streamed and not static else 1,
                           streamed=int(streamed), wpr=wpr, groups=groups,
                           vec=vec, stage=QR_STAGE, stages=QR_STAGES)


def quant_rows(v, static: bool = False):
    """v [M, K] bf16 or f32 -> (int8 codes, row scale [M] f32), or with
    `static` the codes clip(round(v), +-127) alone. On CUDA each row up
    to the ring's size (96 KB) is read once, through a ring of TMA bulk
    copies (`quant_rows_launch`)."""
    if exporting():
        out = _quant_rows_op(v, static)
        return out[0] if static else tuple(out)
    if not _on_cuda(v):
        return _quant_rows_ref(v, static)
    return _quant_rows_cuda(v, static)


def _quant_rows_cuda(v, static: bool):
    m, k = v.shape
    if k % 8:
        raise ValueError(f"quant_rows needs K % 8 == 0; got K={k}")
    if v.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_rows takes bf16 or f32, got {v.dtype}")
    if not v.is_contiguous() or v.data_ptr() % 16:
        raise ValueError("v must be contiguous and 16-byte aligned")
    q = torch.empty((m, k), dtype=torch.int8, device=v.device)
    scale = None if static else _f32((m,), v)
    err = _build.lib().mst_quant_rows(
        v.data_ptr(), int(v.dtype == torch.float32), q.data_ptr(),
        _ptr(scale), m, k, fb._sms(v), _stream(v))
    _build.check(err, "mst_quant_rows")
    quant_rows.launches += 1
    return q if static else (q, scale)


def _check_i8_residual_shape(m: int, k: int, n: int) -> None:
    """Raise ValueError for codes [m, k] -> [m, n] that `gemm_i8_residual`
    does not take (K whole 128-deep stages, N whole 128-column tiles); the
    wrapper calls it before any launch."""
    if m < 1 or k < I8_BK or k % I8_BK or n < fb.GEMM_BN or n % fb.GEMM_BN:
        raise ValueError(f"gemm_i8_residual needs M >= 1, K % {I8_BK} == 0 "
                         f"and N % {fb.GEMM_BN} == 0; got M={m}, K={k}, N={n}")


def gemm_i8_residual_launch(m: int, k: int, n: int,
                            sms: int = fb.H100_SMS) -> SimpleNamespace:
    """The launch geometry of `gemm_i8_residual` at codes [m, k] -> [m, n]
    on a card of `sms` SMs (csrc/gemm_i8_residual.cu
    `mst_i8_residual_geometry`): one persistent CTA per SM over the 128 x
    128 output tiles (fewer if there are fewer tiles), threads, stages,
    dynamic shared memory, k tiles of 128 and the first W^T row of tile 0's
    second box. Raises ValueError where the kernel would."""
    _check_i8_residual_shape(m, k, n)
    tiles = -(-m // fb.GEMM_BM) * (n // fb.GEMM_BN)
    return SimpleNamespace(tiles=tiles, grid=min(tiles, sms),
                           threads=fb.GEMM_THREADS, stages=fb.GEMM_STAGES,
                           smem=fb.GEMM_SMEM, k_tiles=k // I8_BK,
                           second_box=64)


def gemm_i8_residual(a, row_scale, q8, scale, bias, ls, x, q8t=None):
    """x + ls * (f32(a @ q8) [* row_scale] * scale + bias): a [M, K] int8,
    row_scale [M] f32 or None (static), q8 [K, N] int8, x [M, N] bf16. On
    CUDA the int8 wgmma GEMM reads `q8t` [N, K], the K-major copy of q8
    (`QDense.q8t`)."""
    if exporting():
        q8t = _need_q8t(q8t, "gemm_i8_residual")
        return _gemm_i8_residual_op(a, row_scale, q8t, scale, bias, ls, x)
    if not _on_cuda(x):
        return _gemm_i8_residual_ref(a, row_scale, q8, scale, bias, ls, x)
    m, k = a.shape
    n = q8.shape[1]
    _check_i8_residual_shape(m, k, n)
    _codes(a, "a", (m, k), x)
    _kmajor(q8, q8t, n, k, x, "gemm_i8_residual")
    return _gemm_i8_residual_cuda(a, row_scale, q8t, scale, bias, ls, x)


def _gemm_i8_residual_cuda(a, row_scale, q8t, scale, bias, ls, x):
    m, k = a.shape
    n = q8t.shape[0]
    _check_i8_residual_shape(m, k, n)
    _codes(a, "a", (m, k), x)
    _codes(q8t, "q8t", (n, k), x)
    _mat(x, "x", (m, n), x)
    row_scale = _row_scale(row_scale, m, x)
    scale, bias = _vec(scale, "scale", n, x), _vec(bias, "bias", n, x)
    ls = None if ls is None else _vec(ls, "ls", n, x)
    out = torch.empty_like(x)
    err = _build.lib().mst_gemm_i8_residual(
        a.data_ptr(), q8t.data_ptr(), _ptr(row_scale), scale.data_ptr(),
        bias.data_ptr(), _ptr(ls), x.data_ptr(), out.data_ptr(), m, k, n,
        _stream(x))
    _build.check(err, "mst_gemm_i8_residual")
    gemm_i8_residual.launches += 1
    return out


# ---------------------------------------------------------------------------
# The int8 serving kernels as registered ops (`torch.ops.mst_tpu_torch.*`),
# as `fused_block.py` registers the bf16 ones: CUDA the launch, CPU the
# plain version, fake the outputs' shapes and dtypes (all contiguous)
# ---------------------------------------------------------------------------

_T = torch.Tensor


@torch.library.custom_op("mst_tpu_torch::ln_quant_rows", mutates_args=(),
                         device_types="cuda")
def _ln_quant_rows_op(x: _T, ln_s: _T, ln_b: _T, eps: float,
                      static: bool) -> list[_T]:
    q, hs = _ln_quant_rows_cuda(x, ln_s, ln_b, eps, static)
    return [q] if static else [q, hs]


@_ln_quant_rows_op.register_kernel("cpu")
def _(x, ln_s, ln_b, eps, static):
    q, hs = _quantize_ln(x, ln_s, ln_b, eps, static)
    return [q] if static else [q, hs]


@_ln_quant_rows_op.register_fake
def _(x, ln_s, ln_b, eps, static):
    q = x.new_empty(x.shape, dtype=torch.int8)
    return [q] if static else [q, x.new_empty(x.shape[:1],
                                              dtype=torch.float32)]


def _gemm_i8_out(hq, hs, q8t, a_inv, act: int, gated: bool, dtype):
    """(mode, output width, output dtype) of the `gemm_i8` op: the qkv's
    bf16 (ACT_NONE without a_inv), a static tree's int8 codes (hs is None),
    else f32."""
    n = q8t.shape[0] // 2 if gated else q8t.shape[0]
    if not gated and act == ACT_NONE and a_inv is None:
        return OUT_BF16, n, dtype
    if hs is None:
        return OUT_I8, n, torch.int8
    return OUT_F32, n, torch.float32


@torch.library.custom_op("mst_tpu_torch::gemm_i8", mutates_args=(),
                         device_types="cuda")
def _gemm_i8_op(hq: _T, hs: Optional[_T], q8t: _T, scale: _T, bias: _T,
                a_inv: Optional[_T], act: int, gated: bool,
                dtype: torch.dtype) -> _T:
    m, k = hq.shape
    mode, n, out_dtype = _gemm_i8_out(hq, hs, q8t, a_inv, act, gated, dtype)
    _check_i8_shape(m, k, n, gated)
    _codes(hq, "hq", (m, k), hq)
    _codes(q8t, "q8t", (q8t.shape[0], k), hq)
    hs = _row_scale(hs, m, hq)
    scale = _vec(scale, "scale", q8t.shape[0], hq)
    bias = _vec(bias, "bias", q8t.shape[0], hq)
    ainv = None
    if mode == OUT_I8:
        _, ainv = _out_mode(True, a_inv, hq)
    out = torch.empty((m, n), dtype=out_dtype, device=hq.device)
    _gemm_i8(hq, hs, q8t, scale, bias, ainv, out, mode, act, gated)
    wrapper = ln_gemm_i8_swiglu if gated else ln_gemm_i8
    wrapper.launches += 1
    return out


@_gemm_i8_op.register_kernel("cpu")
def _(hq, hs, q8t, scale, bias, a_inv, act, gated, dtype):
    static = hs is None
    if gated:
        return _gemm_i8_swiglu_ref(hq, hs, q8t, scale, bias, dtype, static,
                                   a_inv)
    return _gemm_i8_ref(hq, hs, q8t, scale, bias, act, dtype, static, a_inv)


@_gemm_i8_op.register_fake
def _(hq, hs, q8t, scale, bias, a_inv, act, gated, dtype):
    _, n, out_dtype = _gemm_i8_out(hq, hs, q8t, a_inv, act, gated, dtype)
    return _rows(hq, n, out_dtype)


@torch.library.custom_op("mst_tpu_torch::quant_rows", mutates_args=(),
                         device_types="cuda")
def _quant_rows_op(v: _T, static: bool) -> list[_T]:
    out = _quant_rows_cuda(v, static)
    return [out] if static else list(out)


@_quant_rows_op.register_kernel("cpu")
def _(v, static):
    out = _quant_rows_ref(v, static)
    return [out] if static else list(out)


@_quant_rows_op.register_fake
def _(v, static):
    q = v.new_empty(v.shape, dtype=torch.int8)
    return [q] if static else [q, v.new_empty(v.shape[:1],
                                              dtype=torch.float32)]


@torch.library.custom_op("mst_tpu_torch::gemm_i8_residual", mutates_args=(),
                         device_types="cuda")
def _gemm_i8_residual_op(a: _T, row_scale: Optional[_T], q8t: _T, scale: _T,
                         bias: _T, ls: Optional[_T], x: _T) -> _T:
    return _gemm_i8_residual_cuda(a, row_scale, q8t, scale, bias, ls, x)


@_gemm_i8_residual_op.register_kernel("cpu")
def _(a, row_scale, q8t, scale, bias, ls, x):
    return _gemm_i8_residual_ref(a, row_scale, q8t.t(), scale, bias, ls, x)


_gemm_i8_residual_op.register_fake(
    lambda a, row_scale, q8t, scale, bias, ls, x: _rows(x, x.shape[1]))


# ---------------------------------------------------------------------------
# Sub-layers
# ---------------------------------------------------------------------------


def fused_attention_sublayer_i8(x, ln_s, ln_b, qkv, proj, ls, num_heads,
                                eps=1e-6, rope_cos=None, rope_sin=None,
                                static=False, want_row=False, carry=None,
                                abnar=False):
    """y = x + ls * proj_i8(MHSA_bf16([RoPE](qkv_i8(LN(x))))) for x [N, S,
    E]; `qkv` / `proj`: `QDense`s (`static`: their folded scales). The
    saliency flags as `mhsa`'s forms: `want_row` the per-head CLS softmax
    row [N, heads, S] f32, `carry` [N, heads, S] f32 the rollout carry moved
    one block on, `abnar` the Abnar factor [N, S, S] f32; -> y, or (y,
    [row], [abnar factor], [new carry]). With the static scales the
    v-columns arrive divided by the attention output's scale, which cancels
    in the softmax rows (they are built from q and k alone)."""
    if not (exporting() or _on_cuda(x)):
        return _attn_i8_ref(x, ln_s, ln_b, qkv, proj, ls, num_heads, eps,
                            rope_cos, rope_sin, static, want_row, carry,
                            abnar)
    _check_flags(want_row, carry, abnar)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    t = ln_gemm_i8(x2, ln_s, ln_b, qkv.q8, qkv.scale, qkv.bias, ACT_NONE,
                   eps, static, q8t=qkv.q8t)
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if carry is not None:
        out = mhsa_rollout(t, carry, n, s, num_heads, want_row=want_row,
                           **rope)
    elif abnar:
        out = mhsa_abnar(t, n, s, num_heads, **rope)
    elif want_row:
        out = mhsa_with_row(t, n, s, num_heads, **rope)
    else:
        out = mhsa(t, n, s, num_heads, **rope)
    o, *extra = out if isinstance(out, tuple) else (out,)
    oq, osc = (quant_rows(o, True), None) if static else quant_rows(o)
    y = gemm_i8_residual(oq, osc, proj.q8, proj.scale, proj.bias, ls, x2,
                         q8t=proj.q8t)
    _called(fused_attention_sublayer_i8, x)
    y = y.reshape(n, s, e)
    return (y, *extra) if extra else y


def fused_mlp_sublayer_i8(x, ln_s, ln_b, fc1, fc2, ls, approximate,
                          eps=1e-6):
    """y = x + ls * fc2_i8(gelu(fc1_i8(LN(x)))) for x [N, S, E]; a static
    tree is told by the `a_inv` of fc2 (`_fold_static_scales`)."""
    if not (exporting() or _on_cuda(x)):
        return _mlp_i8_ref(x, ln_s, ln_b, fc1, fc2, ls, approximate, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    static = fc2.a_inv is not None
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    u = ln_gemm_i8(x2, ln_s, ln_b, fc1.q8, fc1.scale, fc1.bias, act, eps,
                   static, fc2.a_inv, q8t=fc1.q8t)
    uq, us = (u, None) if static else quant_rows(u)
    y = gemm_i8_residual(uq, us, fc2.q8, fc2.scale, fc2.bias, ls, x2,
                         q8t=fc2.q8t)
    _called(fused_mlp_sublayer_i8, x)
    return y.reshape(n, s, e)


def fused_swiglu_sublayer_i8(x, ln_s, ln_b, w12, w3, ls, eps=1e-6):
    """y = x + ls * w3_i8(silu(h1) * h2), [h1 | h2] = w12_i8(LN(x)), for x
    [N, S, E]: the giant2 FFN in W8A8; static as `fused_mlp_sublayer_i8`
    (the `a_inv` of w3)."""
    if not (exporting() or _on_cuda(x)):
        return _swiglu_i8_ref(x, ln_s, ln_b, w12, w3, ls, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    static = w3.a_inv is not None
    g = ln_gemm_i8_swiglu(x2, ln_s, ln_b, w12.q8, w12.scale, w12.bias, eps,
                          static, w3.a_inv, q8t=w12.q8t)
    gq, gs = (g, None) if static else quant_rows(g)
    y = gemm_i8_residual(gq, gs, w3.q8, w3.scale, w3.bias, ls, x2,
                         q8t=w3.q8t)
    _called(fused_swiglu_sublayer_i8, x)
    return y.reshape(n, s, e)


# ---------------------------------------------------------------------------
# The tree side: a quantized copy of a model, and static calibration
# ---------------------------------------------------------------------------

# The token-wise products of a block, by parent module.
_QUANTIZED = (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2", "w12", "w3")))


def _dense_of(blk):
    """[(parent module, attribute)] of a block's token-wise Dense layers."""
    return [(getattr(blk, p), name) for p, names in _QUANTIZED
            for name in names if hasattr(getattr(blk, p), name)]


def _quantized_ids(enc, quantize_last: bool):
    """The block indices of `enc` that get quantized."""
    return [i for i in range(enc.depth)
            if quantize_last or i != enc.depth - 1]


def _copy_without_kernels(module, enc, ids):
    """A deep copy of `module` that shares (and so never duplicates) the f32
    kernels of the Dense layers about to be replaced: at giant2 they are
    4.4 GB."""
    memo = {}
    for i in ids:
        for parent, name in _dense_of(enc.block(i)):
            kernel = getattr(parent, name).kernel
            memo[id(kernel)] = kernel
    return copy.deepcopy(module, memo)


def _quantize_blocks_(enc, ids, act_scales, margin):
    """Replace the token-wise Dense layers of blocks `ids` of `enc` (in
    place) by `QDense`s and fold the static scales if given."""
    from mst_tpu_torch.models.layers import QDense

    with torch.no_grad():
        for i in ids:
            blk = enc.block(i)
            for parent, name in _dense_of(blk):
                dense = getattr(parent, name)
                q, s = quantize_weight_int8(dense.kernel)
                setattr(parent, name, QDense(q, s, dense.bias.detach().float()
                                             .clone()))
            if act_scales is not None:
                _fold_static_scales(blk, act_scales[f"blocks_{i}"], margin)


def quantize_encoder_int8(enc, act_scales=None, margin: float = 1.05,
                          quantize_last: bool = False):
    """A copy of the VisionTransformer `enc` whose blocks' token-wise
    products (attn.qkv / proj, mlp.fc1 / fc2 or w12 / w3) are `QDense`s,
    from the f32 weights on their device; every other parameter is copied
    as it is. `act_scales` (`calibrate_act_scales_int8`) makes the tree
    static, its scales widened by `margin` and folded
    (`_fold_static_scales`). The last block stays as it is unless
    `quantize_last`."""
    ids = _quantized_ids(enc, quantize_last)
    q = _copy_without_kernels(enc, enc, ids)
    _quantize_blocks_(q, ids, act_scales, margin)
    return q


def _scaled(t, factor: float, divide: bool = False):
    """t * factor, or t / factor correctly rounded on any device (a tensor
    divisor; the JAX body divides an f32 array by an f32 scalar)."""
    t = t.detach().float()
    return t / torch.full_like(t, factor) if divide else t * factor


def _fold_static_scales(blk, sc, margin: float) -> None:
    """Fold one block's calibrated per-tensor abs-maxima `sc` {"attn_in",
    "attn_out", "mlp_in", "mlp_hidden"} into its quantized block (in
    place): the LN emits h / a_in, the qkv dequant recovers a_in and its
    v-columns divide by a_out, so the attention output arrives pre-scaled
    and the proj dequant recovers a_out; the FFN input likewise; the FFN
    hidden keeps the runtime scalar `a_inv` = 1 / b_hid on fc2 / w3."""
    a_in, a_out, b_in, b_hid = (max(float(sc[k]), 1e-12) * margin / 127.0
                                for k in ("attn_in", "attn_out", "mlp_in",
                                          "mlp_hidden"))
    n1, n2 = blk.norm1, blk.norm2
    n1.scale.data = _scaled(n1.scale, a_in, divide=True)
    n1.bias.data = _scaled(n1.bias, a_in, divide=True)
    qkv = blk.attn.qkv
    e = qkv.q8.shape[0]
    colmul = torch.ones((1, 3 * e), dtype=torch.float32,
                        device=qkv.scale.device)
    colmul[:, 2 * e:] = 1.0 / a_out
    qkv.scale = qkv.scale * a_in * colmul
    qkv.bias = qkv.bias * colmul[0]
    blk.attn.proj.scale = blk.attn.proj.scale * a_out
    n2.scale.data = _scaled(n2.scale, b_in, divide=True)
    n2.bias.data = _scaled(n2.bias, b_in, divide=True)
    first, second = ((blk.mlp.w12, blk.mlp.w3) if hasattr(blk.mlp, "w12")
                     else (blk.mlp.fc1, blk.mlp.fc2))
    first.scale = first.scale * b_in
    second.scale = second.scale * b_hid
    second.a_inv = torch.full((1, 1), 1.0 / b_hid, dtype=torch.float32,
                              device=second.scale.device)


def _calib_block(blk, h, rope_cos, rope_sin, eps, approximate, nh, dtype):
    """One block's calibration forward (the JAX `_calib_block`): f32
    sub-layer internals from the f32 weights, the residual stream in
    `dtype`. -> (next h, per-site abs-max 0-dim tensors)."""
    e = h.shape[-1]
    hd = e // nh
    s = {}
    xf = h.float()
    hn = _ln(xf, blk.norm1.scale, blk.norm1.bias, eps)
    s["attn_in"] = hn.abs().amax()
    qkv = hn @ blk.attn.qkv.kernel.float() + blk.attn.qkv.bias.float()
    n, seq, _ = qkv.shape
    q, k, v = qkv.reshape(n, seq, 3, nh, hd).permute(2, 0, 3, 1, 4)
    if rope_cos is not None:
        q, k = (apply_rope_tables(u, rope_cos, rope_sin) for u in (q, k))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    o = (torch.softmax(att, -1) @ v).transpose(1, 2).reshape(n, seq, e)
    s["attn_out"] = o.abs().amax()
    y = o @ blk.attn.proj.kernel.float() + blk.attn.proj.bias.float()
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.float()
    h = (xf + y).to(dtype)
    xf = h.float()
    hn = _ln(xf, blk.norm2.scale, blk.norm2.bias, eps)
    s["mlp_in"] = hn.abs().amax()
    if hasattr(blk.mlp, "w12"):
        h1, h2 = (hn @ blk.mlp.w12.kernel.float()
                  + blk.mlp.w12.bias.float()).chunk(2, dim=-1)
        u = h1 * torch.sigmoid(h1) * h2
        out = blk.mlp.w3
    else:
        u = _gelu(hn @ blk.mlp.fc1.kernel.float() + blk.mlp.fc1.bias.float(),
                  approximate)
        out = blk.mlp.fc2
    s["mlp_hidden"] = u.abs().amax()
    y = u @ out.kernel.float() + out.bias.float()
    if blk.ls2 is not None:
        y = y * blk.ls2.gamma.float()
    return (xf + y).to(dtype), s


def calibrate_act_scales_int8(enc, x, cfg, dtype=torch.bfloat16,
                              chunk: int = 16) -> dict:
    """Per-tensor abs-max at the four quantization sites of every block of
    the unquantized encoder `enc`, from a plain mirror of the kernels' math
    (f32 sub-layer internals, the residual stream in `dtype`, the serving
    precision). x: [N, H, W, 3] slice images; cfg: `vit_fast.FastViTConfig`.
    Slices flow through the encoder independently, so `chunk` of them go
    at a time (the running max is exact) and the [n, heads, S, S]
    attention stays small at giant2 width. -> {"blocks_i": {"attn_in",
    "attn_out", "mlp_in", "mlp_hidden"}} floats."""
    from mst_tpu_torch.models.vit_fast import prepare_vit_tokens

    stats = None
    with torch.no_grad():
        for lo in range(0, x.shape[0], chunk):
            h, rope_cos, rope_sin = prepare_vit_tokens(enc, x[lo:lo + chunk],
                                                       cfg, dtype)
            cs = {}
            for i in range(cfg.depth):
                h, cs[f"blocks_{i}"] = _calib_block(
                    enc.block(i), h, rope_cos, rope_sin, cfg.norm_eps,
                    cfg.gelu_approximate, cfg.num_heads, dtype)
            stats = cs if stats is None else {
                name: {k: torch.maximum(stats[name][k], v)
                       for k, v in s.items()} for name, s in cs.items()}
    return {name: {k: float(v) for k, v in s.items()}
            for name, s in stats.items()}


def quantize_mst_int8(model, calib_source=None, margin: float = 1.05,
                      dtype=torch.bfloat16, quantize_last: bool = False):
    """A copy of the DinoSliceClassifier `model` with its encoder quantized
    (`quantize_encoder_int8`); slice fusion, head and the rest stay full
    precision and are copied. With `calib_source` ([B, C, D, H, W] volumes,
    a tensor or numpy array) the static scales are calibrated on it first
    (`calibrate_act_scales_int8` in `dtype`) and folded: the serving
    kernels then skip the per-token abs-max reductions."""
    enc = model.encoder
    act_scales = _model_act_scales(model, calib_source, dtype)
    ids = _quantized_ids(enc, quantize_last)
    q = _copy_without_kernels(model, enc, ids)
    _quantize_blocks_(q.encoder, ids, act_scales, margin)
    return q


def _model_act_scales(model, calib_source, dtype):
    """`calibrate_act_scales_int8` of `model`'s encoder on the volumes
    `calib_source` ([B, C, D, H, W]), or None without them."""
    from mst_tpu_torch.models.vit_fast import FastViTConfig

    act_scales = None
    if calib_source is not None:
        src = torch.as_tensor(calib_source).to(
            next(model.parameters()).device, torch.float32)
        b, c, d, hh, ww = src.shape
        x = src.permute(0, 2, 3, 4, 1).reshape(b * d, hh, ww, c)
        if c == 1:
            x = x.expand(b * d, hh, ww, 3)
        act_scales = calibrate_act_scales_int8(
            model.encoder, x, FastViTConfig.from_model(model), dtype)
    log.info("int8 (W8A8) encoder: %s", "per-token activation scales"
             if act_scales is None else "static activation scales from "
             f"{len(calib_source)} volumes")
    return act_scales


def quantize_frozen_encoder_int8(model, calib_source=None,
                                 margin: float = 1.05, dtype=torch.bfloat16):
    """The int8 copy of a frozen `model`'s encoder alone, for
    `train --freeze --int8` (JAX `quantize_mst_params_int8({"encoder":
    ...}, model, calib)`, `mst_tpu/train/trainer.py:510-512`): calibrated
    on `calib_source` as `quantize_mst_int8`, and nothing else copied, so
    that the slice fusion and head the step trains stay `model`'s own."""
    return quantize_encoder_int8(
        model.encoder, _model_act_scales(model, calib_source, dtype), margin)


# `.launches` of each kernel wrapper, `.calls` of each sub-layer, counted
# with the bf16 ones (`fused_block.launch_counts()` / `sublayer_calls()`);
# `ln_quant_rows` counts once per `ln_gemm_i8` / `ln_gemm_i8_swiglu` call
# (their LN half).
KERNEL_WRAPPERS = (ln_quant_rows, ln_gemm_i8, ln_gemm_i8_swiglu, quant_rows,
                   gemm_i8_residual)
SUBLAYER_WRAPPERS = (fused_attention_sublayer_i8, fused_mlp_sublayer_i8,
                     fused_swiglu_sublayer_i8)
fb.register_wrappers(KERNEL_WRAPPERS, SUBLAYER_WRAPPERS)
