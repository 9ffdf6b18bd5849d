"""Fused ViT sub-layers on hand-written Hopper kernels.

Counterpart of `mst_tpu/ops/fused_block.py` (plain flags):

- `fused_attention_sublayer`: y = x + ls1 * proj(MHSA(LN1(x)))
- `fused_mlp_sublayer`:       y = x + ls2 * fc2(gelu(fc1(LN2(x))))
- `fused_swiglu_sublayer`:    y = x + ls2 * w3(silu(h1) * h2),
  [h1 | h2] = w12(LN2(x)), the giant2 FFN (`_swiglu_kernel`)
- `fused_attention_sublayer_train` / `fused_mlp_sublayer_train` /
  `fused_swiglu_sublayer_train`: the same forwards as
  `torch.autograd.Function`s that save residuals (qkv, o, the base-2
  log-sum-exp rows; the pre-activation; the pre-gate h12 and the gate) and
  run a hand-written backward from them, never the forward again (the JAX
  `custom_vjp`s; the SwiGLU one is `_swiglu_train_kernel` with the XLA
  `_swiglu_train_bwd`).
- the RoPE forms of the DINOv3 encoder (`has_rope`):
  `fused_attention_sublayer_rope`, `_rope_with_row`, the `rope_cos` /
  `rope_sin` of `_rollout` and `_abnar`, and
  `fused_attention_sublayer_train_rope`. The attention kernels rotate q and
  k where they load them (`mhsa` and `mhsa_bwd`, whose backward also takes
  dq and dk back through the rotation); cos / sin are [S, head_dim] f32
  tables (`ops/rotary.rope_tables`).

On the TPU each is one Pallas program that keeps a slice's whole [S, E]
block and the layer's weights in VMEM. An H100 SM has 227 KB of shared
memory, so each sub-layer here is a short chain of CUDA kernels
(`mst_tpu_torch/csrc/`):

- attention: `ln_gemm` (LN + qkv) -> `mhsa` -> `gemm_residual` (proj + ls + x);
  `ln_gemm` and `ln_gemm_swiglu` are two kernels each, `ln_rows` (LN once
  per row, h = bf16(LN(x))) then a TMA + wgmma GEMM on h
- MLP:       `ln_gemm` (LN + fc1 + GELU) -> `gemm_residual` (fc2 + ls + x)
- SwiGLU:    `ln_gemm_swiglu` (LN + w12 + gate; in train mode also h and
  the rounded h12) -> `gemm_residual` (w3 + ls + x)
- backward:  `gemm_dls` (ls grad), `gemm_wgrad` (weight and bias grads),
  `gemm_dgrad` (input grads, with the GELU' or the SiLU-gate epilogue, or
  dh in f32 for the LN pullback of the row kernel `ln_pullback`),
  `mhsa_bwd` (dq, dk, dv), chained by `_attn_train_bwd` /
  `_mlp_train_bwd` / `_swiglu_train_bwd`; `gemm_residual` and `gemm_dls`
  run on the TMA + wgmma GEMM of `ln_gemm` with epilogues of their own,
  `gemm_dgrad` and `gemm_wgrad` on it with operand layouts of their own

Every kernel wrapper dispatches on the device of the tensor it is given: a
CUDA tensor launches the kernel (bf16 only) and counts the launch; a CPU
tensor takes the kernel's plain PyTorch version, which rounds to the
working dtype at the same points as the kernel and the Pallas body (qkv
after its bias, P before P.V, o / l, the GELU output, the SwiGLU gate
taken on the f32 h12, the residual sum in f32; in the train bodies also the
pre-activation before its GELU, h12 before its gate, gz, do, p before dv,
ds, dq / dk / dv, da, du before the gate's derivative, dh12). There is no
fallback from one to the other. Each train sub-layer
composes the kernel wrappers through an `ops`
table (`KERNELS`), so the CPU runs the same composition on the plain
versions, and `PLAIN` runs it on the plain versions on any device. The
plain versions upcast to f32 but keep f64 as it is (`_f`), so that the
plain path in f64 is an oracle for the bf16 paths.

Argument conventions follow the JAX package: x [N, S, E]; matrices in the
flax Dense layout [in, out]; LN scale / bias, biases and LayerScale as
vectors (used in f32); `ls=None` means no LayerScale.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops.attention import (
    _on_cuda,
    exporting,
    flash_abnar,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_carry,
    flash_fwd,
    flash_row,
)
from mst_tpu_torch.ops.rotary import _rotate_half_interleaved, apply_rope_tables

_LOG2E = math.log2(math.e)

# Activation codes of `ln_gemm` (csrc/common.cuh `Act`); ACT_SWIGLU asks
# `gemm_dgrad` for its SiLU-gate epilogue.
ACT_NONE, ACT_GELU_TANH, ACT_GELU_ERF, ACT_SWIGLU = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _f(t):
    """t in f32, or as it is if it is f64 (the plain path in f64 keeps its
    precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _ln(x, scale, bias, eps=1e-6):
    """LayerNorm in f32 (two-pass statistics, as the Pallas bodies)."""
    xf = _f(x)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * _f(scale) + _f(bias)


def _gelu(x, approximate: bool):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _mm(a, b):
    """Product of working-dtype operands with f32 accumulation and an f32
    result (the kernels' and Pallas' `preferred_element_type=f32`)."""
    return torch.matmul(_f(a), _f(b))


def _ln_rows_ref(x, ln_s, ln_b, eps: float):
    """bf16(LN(x)) (the working dtype): `ln_rows`' plain version."""
    return _ln(x, ln_s, ln_b, eps).to(x.dtype)


def _gemm_act_ref(h, w, b, act: int, train: bool = False):
    """The GEMM half of `ln_gemm` on the normalised rows h: act(h @ w + b),
    or with `train` (pre, post) = (bf16(h @ w + b), bf16(act(pre)) or None
    for ACT_NONE)."""
    y = _mm(h, w) + _f(b)
    if train:
        pre = y.to(h.dtype)
        post = None if act == ACT_NONE else _gelu(
            _f(pre), act == ACT_GELU_TANH).to(h.dtype)
        return pre, post
    if act != ACT_NONE:
        y = _gelu(y, act == ACT_GELU_TANH)
    return y.to(h.dtype)


def _gemm_swiglu_ref(h, w12, b12, train: bool = False):
    """The GEMM half of `ln_gemm_swiglu`: bf16(silu(h1) * h2) with [h1 |
    h2] = h @ w12 + b12 in f32, or with `train` (h12, g) = (bf16(h @ w12 +
    b12), the gate of the ROUNDED h12)."""
    h12 = _mm(h, w12) + _f(b12)
    if train:
        h12 = h12.to(h.dtype)
    h1, h2 = _f(h12).chunk(2, dim=-1)
    g = (h1 * torch.sigmoid(h1) * h2).to(h.dtype)
    return (h12, g) if train else g


def _ln_gemm_ref(x, ln_s, ln_b, w, b, act: int, eps: float,
                 train: bool = False):
    """`_ln_rows_ref` then `_gemm_act_ref`; with `train` (pre, h, post)."""
    h = _ln_rows_ref(x, ln_s, ln_b, eps)
    if train:
        pre, post = _gemm_act_ref(h, w, b, act, train=True)
        return pre, h, post
    return _gemm_act_ref(h, w, b, act)


def _ln_gemm_swiglu_ref(x, ln_s, ln_b, w12, b12, eps: float,
                        train: bool = False):
    """bf16(silu(h1) * h2) with [h1 | h2] = LN(x) @ w12 + b12 in f32: the
    gate on the f32 h12, as `_swiglu_kernel` (the JAX XLA `_swiglu_ref`
    rounds h12 to bf16 first; in f32 the two agree). With `train`: (h12, h,
    g) = (bf16(LN(x) @ w12 + b12), bf16(LN(x)), the gate of the ROUNDED
    h12), the residuals of `_swiglu_train_kernel`."""
    h = _ln_rows_ref(x, ln_s, ln_b, eps)
    if train:
        h12, g = _gemm_swiglu_ref(h, w12, b12, train=True)
        return h12, h, g
    return _gemm_swiglu_ref(h, w12, b12)


def _has_rope(rope_cos, rope_sin) -> bool:
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin go together: give both or "
                         "neither")
    return rope_cos is not None


def _rope_adjoint_ref(d, cos, sin, dt):
    """The rotation's adjoint on the f32 grad d of the rotated values, with
    the JAX backward's rounding point: d * cos - bf16(d * sin) @ P (f32)."""
    return d * cos - _rotate_half_interleaved(_f((d * sin).to(dt)))


def _mhsa_ref(qkv, n: int, s: int, num_heads: int, want_lse: bool = False,
              want_row: bool = False, carry=None, want_abnar: bool = False,
              rope_cos=None, rope_sin=None):
    """o [n*s, E], then in the JAX `_mhsa` order the optional outputs, each
    from the f32 p before its bf16 cast: the CLS row p[0] / l [n, heads, s];
    the Abnar factor rownorm(mean_h p / l + I) [n, s, s]; the base-2 LSE
    [n*s, heads]; the rollout carry sum_i carry_i / l_i * p[i] [n, heads, s].
    With `rope_cos` / `rope_sin` ([s, hd] f32) q and k are rotated first."""
    e = qkv.shape[1] // 3
    hd = e // num_heads
    dt = qkv.dtype
    t = qkv.reshape(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [n, heads, s, hd]
    if _has_rope(rope_cos, rope_sin):
        q, k = (apply_rope_tables(u, rope_cos, rope_sin) for u in (q, k))
    sc = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd) * _LOG2E)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp2(sc - m)
    l = p.sum(-1, keepdim=True)
    o = (_mm(p.to(dt), v) / l).to(dt)
    out = (o.permute(0, 2, 1, 3).reshape(n * s, e),)
    if want_row:
        out += ((p[:, :, 0] / l[:, :, 0]).contiguous(),)
    if want_abnar:
        ab = p[:, 0] / l[:, 0]
        for h in range(1, num_heads):  # the heads summed in order
            ab = ab + p[:, h] / l[:, h]
        a = ab * (1.0 / num_heads) + torch.eye(s, device=p.device,
                                               dtype=p.dtype)
        out += (a / a.sum(-1, keepdim=True),)
    if want_lse:
        # base-2 log-sum-exp in the scaled units, [n * s, heads] (JAX's
        # [N, S, H])
        lse = (m + torch.log2(l))[..., 0].permute(0, 2, 1)
        out += (lse.reshape(n * s, num_heads).contiguous(),)
    if carry is not None:
        r = _f(carry) * (1.0 / l[..., 0])  # [n, heads, s]
        out += ((r[..., None] * p).sum(-2),)
    return out if len(out) > 1 else out[0]


def _gemm_residual_ref(a, w, b, ls, x):
    y = _mm(a, w) + _f(b)
    if ls is not None:
        y = y * _f(ls)
    return (_f(x) + y).to(x.dtype)


def _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
              eps=1e-6, **flags):
    """The attention sub-layer; `flags` (`_mhsa_ref`'s optional outputs)
    make it return (y, *those outputs)."""
    n, s, e = x.shape
    dt = x.dtype
    x2 = x.reshape(n * s, e)
    qkv = _ln_gemm_ref(x2, ln_s, ln_b, wqkv.to(dt), bqkv, ACT_NONE, eps)
    o = _mhsa_ref(qkv, n, s, num_heads, **flags)
    o, extra = (o[0], o[1:]) if isinstance(o, tuple) else (o, ())
    y = _gemm_residual_ref(o, wproj.to(dt), bproj, ls, x2).reshape(n, s, e)
    return (y, *extra) if extra else y


def _attn_rope_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, cos, sin,
                   num_heads, eps=1e-6):
    """The RoPE attention sub-layer (`mst_tpu` `_attn_rope_ref`, with the
    kernels' rounding points)."""
    return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                     eps, rope_cos=cos, rope_sin=sin)


def _attn_with_row_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                       num_heads, eps=1e-6):
    return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                     eps, want_row=True)


def _attn_rope_with_row_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, cos,
                            sin, num_heads, eps=1e-6):
    return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                     eps, want_row=True, rope_cos=cos, rope_sin=sin)


def _attn_rollout_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, carry,
                      num_heads, eps=1e-6, rope_cos=None, rope_sin=None,
                      want_row=False):
    return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                     eps, want_row=want_row, carry=carry, rope_cos=rope_cos,
                     rope_sin=rope_sin)


def _attn_abnar_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                    eps=1e-6, rope_cos=None, rope_sin=None):
    return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, num_heads,
                     eps, want_abnar=True, rope_cos=rope_cos,
                     rope_sin=rope_sin)


def _mlp_ref(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate, eps=1e-6):
    n, s, e = x.shape
    dt = x.dtype
    x2 = x.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    h = _ln_gemm_ref(x2, ln_s, ln_b, w1.to(dt), b1, act, eps)
    return _gemm_residual_ref(h, w2.to(dt), b2, ls, x2).reshape(n, s, e)


def _swiglu_ref(x, ln_s, ln_b, w12, b12, w3, b3, ls, eps=1e-6):
    """The SwiGLU sub-layer with the kernels' rounding points."""
    n, s, e = x.shape
    dt = x.dtype
    x2 = x.reshape(n * s, e)
    g = _ln_gemm_swiglu_ref(x2, ln_s, ln_b, w12.to(dt), b12, eps)
    return _gemm_residual_ref(g, w3.to(dt), b3, ls, x2).reshape(n, s, e)


# -- plain versions of the backward kernels (`_attn_bwd_kernel`,
# `_mlp_bwd_kernel` in mst_tpu/ops/fused_block.py, step by step) ----------


def _ln_recompute(x, eps):
    """LN statistics recomputed from x in f32 -> (xhat, rstd)."""
    xf = _f(x)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def _act_grad(a, act: int):
    """d act(a) / da in f32: the closed form of the GELU flavour the
    forward used (JAX takes it by a JVP of the same function)."""
    if act == ACT_GELU_TANH:
        k0, k1 = math.sqrt(2.0 / math.pi), 0.044715
        t = torch.tanh(k0 * (a + k1 * a * a * a))
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * k0 * (
            1.0 + 3.0 * k1 * a * a)
    if act == ACT_GELU_ERF:
        return 0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0)))) + a * (
            1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * a * a)
    return torch.ones_like(a)


def _gemm_dls_ref(a, w, b, ls, g):
    """(gz = g * ls in the working dtype, dls = sum_m g * (a @ w + b))."""
    gf = _f(g)
    z = _mm(a, w) + _f(b)
    return (gf * _f(ls)).to(g.dtype), (gf * z).sum(0)


def _gemm_wgrad_ref(a, b):
    """(a^T @ b, column sums of b), both f32."""
    return _mm(a.t(), b), _f(b).sum(0)


def _ln_pullback_ref(d, x, g, ln_s, eps):
    """The LN pullback plus the residual from dh = d (f32) -> (dx, dln_s,
    dln_b): `_ln_bwd` of mst_tpu/ops/fused_block.py with the kernels'
    rounding (one cast of dx)."""
    xhat, rstd = _ln_recompute(x, eps)
    dxhat = d * _f(ln_s)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + _f(g)).to(x.dtype)
    return dx, (d * xhat).sum(0), d.sum(0)


def _swiglu_grad(du, h12):
    """dh12 of the SiLU gate g = silu(h1) * h2 from the f32 du [M, F] and
    the saved h12 [M, 2F] (`_swiglu_train_bwd`'s order of operations)."""
    h1, h2 = _f(h12).chunk(2, dim=-1)
    sig = torch.sigmoid(h1)
    silu = h1 * sig
    return torch.cat([du * h2 * (sig + silu * (1.0 - sig)), du * silu], -1)


def _gemm_dgrad_ref(dy, w, a=None, act: int = ACT_NONE, ln=None):
    """dy @ w^T (f32), then: with `ln` = (x, g, ln_s, eps) the LN pullback
    plus the residual -> (dx, dln_s, dln_b); with `a` and ACT_SWIGLU the
    SiLU gate's derivative, a = h12 [M, 2K] -> dh12 [M, 2K] (du rounded to
    the working dtype first, as the XLA product of `_swiglu_train_bwd`);
    with `a` the GELU' epilogue -> bf16(d * act'(a)); else d in dy's
    dtype."""
    d = _mm(dy, w.t())
    if ln is not None:
        return _ln_pullback_ref(d, *ln)
    if act == ACT_SWIGLU:
        return _swiglu_grad(_f(d.to(dy.dtype)), a).to(dy.dtype)
    if a is not None:
        return (d * _act_grad(_f(a), act)).to(dy.dtype)
    return d.to(dy.dtype)


def _mhsa_bwd_ref(qkv, o, do, lse, n: int, s: int, num_heads: int,
                  rope_cos=None, rope_sin=None):
    """dqkv [n*s, 3E] from the saved qkv, o, lse and the upstream do:
    p = exp2(s - b) rebuilt from the log-sum-exp rows, delta = rowdot(do, o).
    With the RoPE tables the rotated q and k are recomputed from the
    pre-rope qkv and dq, dk go back through the rotation's adjoint."""
    e = qkv.shape[1] // 3
    hd = e // num_heads
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(hd)
    t = qkv.reshape(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [n, heads, s, hd]
    rope = _has_rope(rope_cos, rope_sin)
    if rope:
        q, k = (apply_rope_tables(u, rope_cos, rope_sin) for u in (q, k))

    def heads(u):
        return u.reshape(n, s, num_heads, hd).permute(0, 2, 1, 3)

    do_h, o_h = heads(do), heads(o)
    b = lse.reshape(n, s, num_heads).permute(0, 2, 1)[..., None]
    p = torch.exp2(_mm(q, k.transpose(-1, -2)) * (scale * _LOG2E) - b)
    dv = _mm(p.to(dt).transpose(-1, -2), do_h).to(dt)
    dp = _mm(do_h, v.transpose(-1, -2))
    delta = (_f(do_h) * _f(o_h)).sum(-1, keepdim=True)
    ds = ((dp - delta) * p * scale).to(dt)
    dq, dk = _mm(ds, k), _mm(ds.transpose(-1, -2), q)
    if rope:
        dq, dk = (_rope_adjoint_ref(u, rope_cos, rope_sin, dt)
                  for u in (dq, dk))
    dq, dk = dq.to(dt), dk.to(dt)
    # [3, n, heads, s, hd] -> [n, s, 3, heads, hd]
    return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(n * s, 3 * e)


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
            f"{name} requires grad: the serving kernels have no backward; "
            f"train through fused_attention_sublayer_train / "
            f"fused_mlp_sublayer_train, or run under torch.no_grad() or "
            f"torch.inference_mode()")
    return t


def _vec(t, name, n, like):
    """A parameter vector as the kernels read it: [n] f32, contiguous,
    16-byte aligned, on the device of `like` (the JAX package's `_vec`).
    The kernels read vectors in 8- and 16-byte loads, so a view at another
    offset of its storage (as `vector_to_parameters` makes) is copied."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} elements, expected {n}")
    v = t.detach().reshape(n).to(torch.float32).contiguous()
    return v.clone() if v.data_ptr() % 16 else v


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f32(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _tables(rope_cos, rope_sin, s, like):
    """The RoPE tables as the attention kernels read them ([s, 64] f32,
    contiguous, on `like`'s device): their pointers, or (None, None)."""
    if not _has_rope(rope_cos, rope_sin):
        return None, None
    for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (s, 64)
                or not t.is_contiguous() or t.device != like.device):
            raise ValueError(f"{name} must be contiguous f32 {(s, 64)} on "
                             f"{like.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return rope_cos.data_ptr(), rope_sin.data_ptr()


def _count(fn, form=None) -> None:
    """One launch of `fn`'s kernel: under `.form_launches[form]` for one of
    its forms (`FORMS`), else `.launches`."""
    if form is None:
        fn.launches += 1
    else:
        fn.form_launches[form] += 1


def _rope_form(rope_cos):
    return None if rope_cos is None else "rope"


def _called(sublayer, x) -> None:
    """One call of `sublayer` that ran its kernel chain: counted on CUDA
    tensors, not on the CPU path nor while `torch.export` records ops."""
    if x.device.type == "cuda" and not exporting():
        sublayer.calls += 1


# The GEMM of `ln_gemm` / `ln_gemm_swiglu` (csrc/gemm_sm90.cuh): 128 x 128
# output tiles (gated: 64 output columns, whose h1 and h2 panels make the
# 128 W columns of a tile), k in steps of 64.
GEMM_BM, GEMM_BN, GEMM_BK = 128, 128, 64


def _check_gemm_shape(m: int, k: int, n: int, gated: bool) -> None:
    """Raise ValueError for an h [m, k] -> n (gated: n = F) the GEMM does
    not take; the wrappers call it before any launch."""
    bn_out = GEMM_BN // 2 if gated else GEMM_BN
    if m < 1 or k < GEMM_BK or k % GEMM_BK or n < bn_out or n % bn_out:
        name, width = ("ln_gemm_swiglu", "F") if gated else ("ln_gemm", "N")
        raise ValueError(f"{name} needs M >= 1, K % {GEMM_BK} == 0 and "
                         f"{width} % {bn_out} == 0; got M={m}, K={k}, "
                         f"{width}={n}")


# The rest of the GEMM's launch geometry, as gemm_sm90.cuh sets it: a ring
# of 5 stages of one A box [128][64] and two W boxes [64][64] (bf16), two
# consumer warpgroups and one producer warp, one persistent CTA per SM
# (132 on an H100 SXM, the mirrors' default). `ln_gemm_launch` mirrors the
# kernel's own numbers, which `mst_gemm_geometry` exports: the tests hold
# the constants to the header and `chip_smoke.py` holds the whole to the
# export on the card.
GEMM_STAGES, GEMM_THREADS, H100_SMS = 5, 2 * 128 + 32, 132
# Its dynamic shared memory: 1 KB of alignment, the ring (16 KB of A and
# 16 KB of B a stage), one 17 KB staging tile per consumer warpgroup (bf16
# [64][BN + 8], or f32 [64][68] for the backward GEMMs) and the barriers.
GEMM_SMEM = (1024 + GEMM_STAGES * (GEMM_BM * GEMM_BK * 2 + 2 * GEMM_BK * 64 * 2)
             + 2 * 64 * (GEMM_BN + 8) * 2 + 2 * GEMM_STAGES * 8)


def ln_gemm_launch(m: int, k: int, n: int, gated: bool = False,
                   sms: int = H100_SMS) -> SimpleNamespace:
    """The launch geometry of `ln_gemm`'s GEMM (`gated`: `ln_gemm_swiglu`'s,
    n = F) at h [m, k] on a card of `sms` SMs (csrc/ln_gemm.cu
    `mst_gemm_geometry`): tiles, grid, threads, stages and dynamic shared
    memory in bytes. Raises ValueError where the kernel would."""
    _check_gemm_shape(m, k, n, gated)
    tiles = -(-m // GEMM_BM) * (n // (GEMM_BN // 2 if gated else GEMM_BN))
    return SimpleNamespace(tiles=tiles, grid=min(tiles, sms),
                           threads=GEMM_THREADS, stages=GEMM_STAGES,
                           smem=GEMM_SMEM)


def _check_residual_shape(m: int, k: int, n: int,
                         name: str = "gemm_residual") -> None:
    """Raise ValueError for an a [m, k] @ w [k, n] that `gemm_residual.cu`
    does not take (its kernels' 128 x 128 tiles, k in steps of 64); the
    wrappers call it before any launch."""
    if m < 1 or k < GEMM_BK or k % GEMM_BK or n < GEMM_BN or n % GEMM_BN:
        raise ValueError(f"{name} needs M >= 1, K % {GEMM_BK} == 0 and N % "
                         f"{GEMM_BN} == 0; got M={m}, K={k}, N={n}")


def gemm_residual_launch(m: int, k: int, n: int,
                         sms: int = H100_SMS) -> SimpleNamespace:
    """The launch geometry of `gemm_residual` and `gemm_dls` at a [m, k] @
    w [k, n] on a card of `sms` SMs (csrc/gemm_residual.cu
    `mst_residual_geometry`): one work unit per 128 x 128 output tile with
    the whole of K, the GEMM's threads, stages and shared memory, and the
    rows of `gemm_dls`'s f32 partials (one per 64 rows of a). Raises
    ValueError where the kernels would."""
    _check_residual_shape(m, k, n)
    tiles = -(-m // GEMM_BM) * (n // GEMM_BN)
    return SimpleNamespace(tiles=tiles, grid=min(tiles, sms),
                           threads=GEMM_THREADS, stages=GEMM_STAGES,
                           smem=GEMM_SMEM, work_rows=-(-m // 64))


def ln_rows(x, ln_s, ln_b, eps: float):
    """bf16(LN(x)) [M, K]: LN once per row, the first kernel of `ln_gemm`
    and `ln_gemm_swiglu` (whose train modes return it as h)."""
    if exporting():
        return _ln_rows_op(x, ln_s, ln_b, float(eps))
    if not _on_cuda(x):
        return _ln_rows_ref(x, ln_s, ln_b, eps)
    return _ln_rows_cuda(x, ln_s, ln_b, eps)


def _ln_rows_cuda(x, ln_s, ln_b, eps: float):
    m, k = x.shape
    if k % 8 or k > 4096:
        raise ValueError(f"ln_rows needs K % 8 == 0 and K <= 4096; got K={k}")
    _mat(x, "x", (m, k), x)
    ln_s, ln_b = _vec(ln_s, "ln_s", k, x), _vec(ln_b, "ln_b", k, x)
    h = torch.empty_like(x)
    err = _build.lib().mst_ln_rows(x.data_ptr(), ln_s.data_ptr(),
                                   ln_b.data_ptr(), h.data_ptr(), m, k,
                                   float(eps), _stream(x))
    _build.check(err, "mst_ln_rows")
    ln_rows.launches += 1
    return h


def ln_gemm(x, ln_s, ln_b, w, b, act: int, eps: float, train: bool = False):
    """act(LN(x) @ w + b): x [M, K], w [K, N] -> [M, N]. With `train`:
    (pre, h, post) = (bf16(LN(x) @ w + b), bf16(LN(x)), bf16(act(pre)) or
    None for ACT_NONE), the residuals of `_attn_train_kernel` /
    `_mlp_train_kernel`. On CUDA: `ln_rows`, then the GEMM on h."""
    if exporting() and not train:
        return _gemm_act_op(ln_rows(x, ln_s, ln_b, eps), w, b, int(act))
    if not _on_cuda(x):
        return _ln_gemm_ref(x, ln_s, ln_b, w, b, act, eps, train)
    m, k = x.shape
    n = w.shape[1]
    _check_gemm_shape(m, k, n, gated=False)
    _mat(w, "w", (k, n), x)  # x: in `ln_rows`, before its launch
    b = _vec(b, "bias", n, x)
    h = ln_rows(x, ln_s, ln_b, eps)
    out, post = _gemm_act_cuda(h, w, b, act, train)
    return (out, h, post) if train else out


def _gemm_act_cuda(h, w, b, act: int, train: bool = False):
    """The GEMM half of `ln_gemm` on the rows h and checked w, b (counted
    as `ln_gemm`'s launch): -> (out, post | None)."""
    m, k = h.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=h.dtype, device=h.device)
    post = torch.empty_like(out) if train and act != ACT_NONE else None
    err = _build.lib().mst_gemm_act(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(post),
        m, k, n, int(act), _stream(h))
    _build.check(err, "mst_gemm_act")
    ln_gemm.launches += 1
    return out, post


def ln_gemm_swiglu(x, ln_s, ln_b, w12, b12, eps: float, train: bool = False):
    """The gated FFN's first half: x [M, K], w12 [K, 2F] -> g [M, F] =
    bf16(silu(h1) * h2), [h1 | h2] = LN(x) @ w12 + b12 in f32. With `train`
    (`_swiglu_train_kernel`, counted apart): (h12, h, g) = (bf16(LN(x) @
    w12 + b12) [M, 2F], bf16(LN(x)) [M, K], the gate of the rounded h12).
    On CUDA: `ln_rows`, then the gated GEMM on h."""
    if exporting() and not train:
        return _gemm_swiglu_op(ln_rows(x, ln_s, ln_b, eps), w12, b12)
    if not _on_cuda(x):
        return _ln_gemm_swiglu_ref(x, ln_s, ln_b, w12, b12, eps, train)
    m, k = x.shape
    f2 = w12.shape[1]
    _check_swiglu_shape(m, k, f2)
    _mat(w12, "w12", (k, f2), x)  # x: in `ln_rows`, before its launch
    b12 = _vec(b12, "b12", f2, x)
    h = ln_rows(x, ln_s, ln_b, eps)
    out, h12 = _gemm_swiglu_cuda(h, w12, b12, train)
    return (h12, h, out) if train else out


def _check_swiglu_shape(m: int, k: int, f2: int) -> None:
    if f2 % 2:
        raise ValueError(f"w12 needs an even width 2F; got {f2}")
    _check_gemm_shape(m, k, f2 // 2, gated=True)


def _gemm_swiglu_cuda(h, w12, b12, train: bool = False):
    """The gated GEMM of `ln_gemm_swiglu` on the rows h and checked w12,
    b12 (counted as its launch): -> (g, h12 | None)."""
    m, k = h.shape
    f2 = w12.shape[1]
    out = torch.empty((m, f2 // 2), dtype=h.dtype, device=h.device)
    h12 = (torch.empty((m, f2), dtype=h.dtype, device=h.device) if train
           else None)
    err = _build.lib().mst_gemm_swiglu(
        h.data_ptr(), w12.data_ptr(), b12.data_ptr(), out.data_ptr(),
        _ptr(h12), m, k, f2 // 2, _stream(h))
    _build.check(err, "mst_gemm_swiglu")
    _count(ln_gemm_swiglu, "train" if train else None)
    return out, h12


_SMEM_CAP = 227 * 1024  # dynamic shared memory of one H100 block

# The launch geometry of `mhsa` and `mhsa_bwd` (csrc/attn_sm90.cuh, mhsa.cu,
# mhsa_bwd.cu): one warpgroup per block, which walks the 64-row tiles of a
# (head, slice) (the Abnar form: the heads of a (tile, slice)); the other
# operand of the head resident in shared memory in TMA boxes of 64 rows,
# the last S % 64 rows a 16-row box where they are 16 or fewer; the
# forward in one pass up to S = 272 (every score of a row in registers:
# four 64-key chunks and a tail of 16), in two above.
MHSA_TILE, MHSA_CHUNK, MHSA_TAIL, MHSA_THREADS = 64, 64, 16, 128
MHSA_ONE_PASS_MAX, MHSA_MAX_S = 4 * 64 + 16, 512
# the tiles a block walks: the fewest blocks of at most 5 (forward) or 3
# (backward) tiles, the tiles shared out evenly
MHSA_MOST_TILES, MHSA_BWD_MOST_TILES = 5, 3
_MHSA_BOX, _MHSA_TAIL_BOX = 64 * 64 * 2, 16 * 64 * 2  # bf16 boxes


def _tiles_per_block(tiles: int, most: int) -> int:
    blocks = -(-tiles // most)
    return -(-tiles // blocks)


def mhsa_launch(s: int) -> SimpleNamespace:
    """The launch geometry of `mhsa` (forward) and `mhsa_bwd` at sequence
    length s, as csrc/mhsa.cu `mst_mhsa_geometry` and mhsa_bwd.cu
    `mst_mhsa_bwd_geometry` export it: the tile, tiles, the tiles a block
    walks (forward, backward), threads, forward passes, 64-row chunks and
    16-row tail chunks, the f32 score registers a forward thread keeps, and
    each kernel's dynamic shared memory (1 KB of alignment; two Q boxes,
    the K and V boxes, the carry's [4][512] f32 sums, the barriers and, in
    the one-pass Abnar kernel, its [136][128] f32 head sum; or two buffers
    of two tile boxes, the two operands' boxes, the f32 LSE and delta of
    every query and the barriers). Raises ValueError past 512."""
    if not 1 <= s <= MHSA_MAX_S:
        raise ValueError(f"mhsa takes 1 <= S <= {MHSA_MAX_S}; got S={s}")
    full, rest = divmod(s, MHSA_CHUNK)
    n64 = full + (rest > MHSA_TAIL)
    tail = int(0 < rest <= MHSA_TAIL)
    boxes = n64 + tail
    operand = n64 * _MHSA_BOX + tail * _MHSA_TAIL_BOX
    one = s <= MHSA_ONE_PASS_MAX
    bars = (2 + boxes) * 8
    tiles = -(-s // MHSA_TILE)
    smem = 1024 + 2 * _MHSA_BOX + 2 * operand + 4 * MHSA_MAX_S * 4 + bars
    return SimpleNamespace(
        tile=MHSA_TILE, tiles=tiles,
        tiles_per_block=_tiles_per_block(tiles, MHSA_MOST_TILES),
        bwd_tiles_per_block=_tiles_per_block(tiles, MHSA_BWD_MOST_TILES),
        threads=MHSA_THREADS, passes=1 if one else 2, chunks64=n64,
        tail16=tail,
        score_regs=(n64 * MHSA_CHUNK + tail * MHSA_TAIL) // 2 if one
        else MHSA_CHUNK // 2,
        smem=smem,
        abnar_smem=smem + (MHSA_ONE_PASS_MAX // 2 * MHSA_THREADS * 4 if one
                           else 0),
        bwd_smem=(1024 + 4 * _MHSA_BOX + 2 * operand
                  + 2 * boxes * MHSA_CHUNK * 4 + bars))


def abnar_query_tile(s: int) -> int:
    """The query tile (rows) of `mhsa_abnar`'s kernel at sequence length s:
    the forward's 64-row tile at every S <= 512 (its f32 head sum takes a
    fixed [136][128] in shared memory, or the factor rows the block owns
    above S = 272)."""
    return mhsa_launch(s).tile


def _mhsa_launch(qkv, n: int, s: int, num_heads: int, want_lse=False,
                 want_row=False, carry=None, want_abnar=False, rope_cos=None,
                 rope_sin=None):
    """Launch `mst_mhsa` with the outputs asked for (NULL for the others)
    and the RoPE tables if given; returns the outputs in `_mhsa_ref`'s
    order."""
    e = qkv.shape[1] // 3
    if e != 64 * num_heads or not 1 <= s <= MHSA_MAX_S:
        raise ValueError(f"mhsa needs head dim 64 and 1 <= S <= 512; got "
                         f"E={e}, heads={num_heads}, S={s}")
    _mat(qkv, "qkv", (n * s, 3 * e), qkv)
    rc, rs = _tables(rope_cos, rope_sin, s, qkv)
    out = torch.empty((n * s, e), dtype=qkv.dtype, device=qkv.device)
    lse = _f32((n * s, num_heads), qkv) if want_lse else None
    row = _f32((n, num_heads, s), qkv) if want_row else None
    abnar = _f32((n, s, s), qkv) if want_abnar else None
    part = new_carry = None
    if carry is not None:
        if (carry.dtype != torch.float32 or tuple(carry.shape) !=
                (n, num_heads, s) or carry.device != qkv.device):
            raise ValueError(f"carry must be f32 {(n, num_heads, s)} on "
                             f"{qkv.device}, got {carry.dtype} "
                             f"{tuple(carry.shape)}")
        carry = carry.contiguous()
        new_carry = _f32((n, num_heads, s), qkv)
        # one partial per query tile of 32 or 64 rows: room for the smaller
        part = _f32((-(-s // 32), n, num_heads, s), qkv)
    err = _build.lib().mst_mhsa(
        qkv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(row), _ptr(carry),
        _ptr(part), _ptr(new_carry), _ptr(abnar), rc, rs, n, s, e,
        num_heads, 1.0 / math.sqrt(64) * _LOG2E, _stream(qkv))
    _build.check(err, "mst_mhsa")
    ret = tuple(t for t in (out, row, abnar, lse, new_carry) if t is not None)
    return ret if len(ret) > 1 else out


def _mhsa_cuda(qkv, carry, rope_cos, rope_sin, n: int, s: int,
               num_heads: int, want_row: bool, want_abnar: bool) -> list:
    """The serving forms' launch, counted under the wrapper of the form
    (`mhsa`, `mhsa_with_row`, `mhsa_rollout`, `mhsa_abnar`): -> [o, *the
    outputs asked for]."""
    ret = _mhsa_launch(qkv, n, s, num_heads, want_row=want_row, carry=carry,
                       want_abnar=want_abnar, rope_cos=rope_cos,
                       rope_sin=rope_sin)
    wrapper = (mhsa_rollout if carry is not None else mhsa_abnar
               if want_abnar else mhsa_with_row if want_row else mhsa)
    _count(wrapper, _rope_form(rope_cos))
    return list(ret) if isinstance(ret, tuple) else [ret]


def _mhsa_via_ops(qkv, n, s, num_heads, carry=None, want_row=False,
                  want_abnar=False, rope_cos=None, rope_sin=None):
    """The serving forms through `mst_tpu_torch::mhsa`, returned as their
    wrappers return them."""
    out = _mhsa_op(qkv, carry, rope_cos, rope_sin, n, s, num_heads,
                   want_row, want_abnar)
    return tuple(out) if len(out) > 1 else out[0]


def mhsa(qkv, n: int, s: int, num_heads: int, want_lse: bool = False,
         rope_cos=None, rope_sin=None):
    """Per-slice softmax attention: qkv [n*s, 3E] -> o [n*s, E]; with
    `want_lse` also the base-2 log-sum-exp rows [n*s, heads] f32. With
    `rope_cos` / `rope_sin` ([s, 64] f32) q and k are rotated first (the
    RoPE form, counted apart)."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if exporting() and not want_lse:
        return _mhsa_via_ops(qkv, n, s, num_heads, **rope)
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads, want_lse, **rope)
    ret = _mhsa_launch(qkv, n, s, num_heads, want_lse=want_lse, **rope)
    _count(mhsa, _rope_form(rope_cos))
    return ret


def mhsa_with_row(qkv, n: int, s: int, num_heads: int, rope_cos=None,
                  rope_sin=None):
    """`mhsa` that also writes the per-head CLS softmax row p[0] / l:
    -> (o, row [n, heads, s] f32)."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if exporting():
        return _mhsa_via_ops(qkv, n, s, num_heads, want_row=True, **rope)
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads, want_row=True, **rope)
    ret = _mhsa_launch(qkv, n, s, num_heads, want_row=True, **rope)
    _count(mhsa_with_row, _rope_form(rope_cos))
    return ret


def mhsa_rollout(qkv, carry, n: int, s: int, num_heads: int,
                 want_row: bool = False, rope_cos=None, rope_sin=None):
    """`mhsa` that moves the rollout carry one block on: new[j] =
    sum_i carry_i / l_i * p_ij, carry [n, heads, s] f32 -> (o, [row,]
    new_carry). One call launches the attention kernel (per-tile partial
    sums) and the fixed-order pass that adds the tiles."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if exporting():
        return _mhsa_via_ops(qkv, n, s, num_heads, carry=carry,
                             want_row=want_row, **rope)
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads, want_row=want_row, carry=carry,
                         **rope)
    ret = _mhsa_launch(qkv, n, s, num_heads, want_row=want_row, carry=carry,
                       **rope)
    _count(mhsa_rollout, _rope_form(rope_cos))
    return ret


def mhsa_abnar(qkv, n: int, s: int, num_heads: int, rope_cos=None,
               rope_sin=None):
    """`mhsa` that also writes the Abnar & Zuidema factor of the block,
    rownorm(mean_h p / l + I): -> (o, factor [n, s, s] f32)."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if exporting():
        return _mhsa_via_ops(qkv, n, s, num_heads, want_abnar=True, **rope)
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads, want_abnar=True, **rope)
    ret = _mhsa_launch(qkv, n, s, num_heads, want_abnar=True, **rope)
    _count(mhsa_abnar, _rope_form(rope_cos))
    return ret


def gemm_residual(a, w, b, ls, x):
    """x + ls * (a @ w + b): a [M, K], w [K, N], x [M, N] -> [M, N]."""
    if exporting():
        return _gemm_residual_op(a, w, b, ls, x)
    if not _on_cuda(x):
        return _gemm_residual_ref(a, w, b, ls, x)
    return _gemm_residual_cuda(a, w, b, ls, x)


def _gemm_residual_cuda(a, w, b, ls, x):
    m, k = a.shape
    n = w.shape[1]
    _check_residual_shape(m, k, n)
    _mat(a, "a", (m, k), x)
    _mat(w, "w", (k, n), x)
    _mat(x, "x", (m, n), x)
    b = _vec(b, "bias", n, x)
    ls = None if ls is None else _vec(ls, "ls", n, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _build.lib().mst_gemm_residual(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(ls), x.data_ptr(),
        out.data_ptr(), m, k, n, _stream(x))
    _build.check(err, "mst_gemm_residual")
    gemm_residual.launches += 1
    return out


def gemm_dls(a, w, b, ls, g):
    """The LayerScale step of the backward: a [M, K], w [K, N], g [M, N] ->
    (gz = g * ls [M, N], dls = sum_m g * (a @ w + b) [N] f32)."""
    if not _on_cuda(g):
        return _gemm_dls_ref(a, w, b, ls, g)
    m, k = a.shape
    n = w.shape[1]
    _check_residual_shape(m, k, n, "gemm_dls")
    _mat(a, "a", (m, k), g)
    _mat(w, "w", (k, n), g)
    _mat(g, "g", (m, n), g)
    b, ls = _vec(b, "bias", n, g), _vec(ls, "ls", n, g)
    gz = torch.empty_like(g)
    dls = _f32((n,), g)
    work = _f32((gemm_residual_launch(m, k, n).work_rows, n), g)
    err = _build.lib().mst_gemm_dls(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), ls.data_ptr(), g.data_ptr(),
        gz.data_ptr(), work.data_ptr(), dls.data_ptr(), m, k, n, _stream(g))
    _build.check(err, "mst_gemm_dls")
    gemm_dls.launches += 1
    return gz, dls


# The widest row of the LN pullback (`ln_pullback`, after `gemm_dgrad`'s f32
# product at every width).
LN_PULLBACK_MAX_K = 1536
# Its launch (csrc/gemm_dgrad.cu): blocks of 8 warps, two an SM; a row
# belongs to a group of 1, 2 or 4 warps (K up to 384, 768, 1536) whose
# lanes hold 2 or 3 chunks of 4 columns each; the second pass sums 32
# columns of the [grid][2][K] partials a block with 8 warps.
_PB_WARPS, _PB_BLOCKS_PER_SM, _PS_WARPS = 8, 2, 8

# `gemm_wgrad` cuts the M rows into chunks of at most _WGRAD_MAX_ROWS (a
# multiple of the GEMM's 64-row k tile): one f32 accumulator's error grows
# with the rows it adds (on the card ~1.3e-9 of the largest sum per row), so
# giant2's w12 grad, 1536 x 8192 tiles enough to fill the card unsplit,
# would add all 65,792 rows in one chain (8e-5). The chunks' f32 partial
# tiles are added in a fixed order.
_WGRAD_MAX_ROWS = 8192

# `gemm_dgrad`'s epilogue modes (csrc/gemm_dgrad.cu `Mode`).
_DGRAD_PLAIN, _DGRAD_GELU, _DGRAD_SWIGLU, _DGRAD_F32 = 0, 1, 2, 3


_SM_COUNTS: dict[int, int] = {}


def _sms(t) -> int:
    """The SM count of the card `t` lies on (the persistent grids' size),
    read once per card: the wrappers ask on every launch."""
    index = t.device.index
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(
            t.device).multi_processor_count
    return _SM_COUNTS[index]


def _check_dgrad_shape(m: int, r: int, k: int) -> None:
    if m < 1 or r < GEMM_BK or r % GEMM_BK or k < GEMM_BN or k % GEMM_BN:
        raise ValueError(f"gemm_dgrad needs M >= 1, R % {GEMM_BK} == 0 and K "
                         f"% {GEMM_BN} == 0; got M={m}, R={r}, K={k}")


def _check_wgrad_shape(m: int, k: int, n: int) -> None:
    if m < 1 or k < GEMM_BM or k % GEMM_BM or n < GEMM_BN or n % GEMM_BN:
        raise ValueError(f"gemm_wgrad needs M >= 1, K % {GEMM_BM} == 0 and N "
                         f"% {GEMM_BN} == 0; got M={m}, K={k}, N={n}")


def gemm_dgrad_launch(m: int, r: int, k: int,
                      sms: int = H100_SMS) -> SimpleNamespace:
    """The launch geometry of `gemm_dgrad` at dy [m, r] -> [m, k] on a card
    of `sms` SMs (csrc/gemm_dgrad.cu `mst_dgrad_geometry`): one work unit
    per 128 x 128 output tile, the whole reduction (rows = r) in each, no
    workspace. Raises ValueError where the kernel would."""
    _check_dgrad_shape(m, r, k)
    units = -(-m // GEMM_BM) * (k // GEMM_BN)
    return SimpleNamespace(units=units, grid=min(units, sms),
                           threads=GEMM_THREADS, stages=GEMM_STAGES,
                           smem=GEMM_SMEM, splits=1, rows=r, workspace=0)


def _check_pullback_shape(m: int, k: int) -> None:
    if m < 1 or k < 32 or k % 32 or k > LN_PULLBACK_MAX_K:
        raise ValueError(f"ln_pullback needs M >= 1, K % 32 == 0 and K <= "
                         f"{LN_PULLBACK_MAX_K}; got M={m}, K={k}")


def ln_pullback_launch(m: int, k: int,
                       sms: int = H100_SMS) -> SimpleNamespace:
    """The launch geometry of `ln_pullback` at dh [m, k] on a card of
    `sms` SMs (csrc/gemm_dgrad.cu `mst_ln_pullback_geometry`): the
    persistent grid of its first pass, its threads, the warps of a row,
    the chunks of 4 columns a lane, its dynamic shared memory (the groups'
    column sums), the workspace bytes of its [grid][2][k] f32 partials,
    and the second pass's blocks and threads. Raises ValueError where the
    kernel would."""
    _check_pullback_shape(m, k)
    wr = 1 if k <= 384 else 2 if k <= 768 else 4
    ch = max(2, -(-k // (128 * wr)))
    groups = _PB_WARPS // wr
    grid = min(-(-m // groups), sms * _PB_BLOCKS_PER_SM)
    return SimpleNamespace(grid=grid, threads=32 * _PB_WARPS, warps_a_row=wr,
                           chunks=ch, smem=groups * 2 * k * 4,
                           workspace=4 * grid * 2 * k,
                           sum_blocks=-(-2 * k // 32),
                           sum_threads=32 * _PS_WARPS)


def gemm_wgrad_launch(m: int, k: int, n: int,
                      sms: int = H100_SMS) -> SimpleNamespace:
    """The launch geometry of `gemm_wgrad` at a [m, k], b [m, n] on a card
    of `sms` SMs (csrc/gemm_wgrad.cu `plan`): the M rows cut into `splits`
    chunks of `rows` (a multiple of 64, at most _WGRAD_MAX_ROWS), as many
    as fill whole waves of (split, 128 x 128 tile) work units; workspace
    bytes for the f32 partial tiles (more than one split) and the db
    partials (two per split). Raises ValueError where the kernel would."""
    _check_wgrad_shape(m, k, n)
    tiles = (k // GEMM_BM) * (n // GEMM_BN)
    need = -(-m // _WGRAD_MAX_ROWS)
    waves = -(-need * tiles // sms)
    splits = max(need, waves * sms // tiles)
    rows = -(-(-(-m // splits)) // GEMM_BK) * GEMM_BK
    splits = -(-m // rows)
    workspace = 4 * ((splits * k * n if splits > 1 else 0) + 2 * splits * n)
    units = tiles * splits
    return SimpleNamespace(units=units, grid=min(units, sms),
                           threads=GEMM_THREADS, stages=GEMM_STAGES,
                           smem=GEMM_SMEM, splits=splits, rows=rows,
                           workspace=workspace)


def gemm_wgrad(a, b):
    """Weight and bias grads: a [M, K], b [M, N] -> (a^T @ b [K, N] f32,
    column sums of b [N] f32)."""
    if not _on_cuda(b):
        return _gemm_wgrad_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    _check_wgrad_shape(m, k, n)
    _mat(a, "a", (m, k), b)
    _mat(b, "b", (m, n), b)
    geo = gemm_wgrad_launch(m, k, n, _sms(b))
    dw, db = _f32((k, n), b), _f32((n,), b)
    work = _f32((geo.workspace // 4,), b)
    err = _build.lib().mst_gemm_wgrad(
        a.data_ptr(), b.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), geo.workspace, m, k, n, _stream(b))
    _build.check(err, "mst_gemm_wgrad")
    gemm_wgrad.launches += 1
    return dw, db


def gemm_dgrad(dy, w, a=None, act: int = ACT_NONE, ln=None):
    """Input grad of a Dense layer, dy [M, R] @ w[K, R]^T, f32 accumulated,
    with the epilogue of `_gemm_dgrad_ref`: `ln` = (x, g, ln_s, eps) ->
    (dx, dln_s, dln_b); `a` = h12 [M, 2K] with ACT_SWIGLU -> dh12 [M, 2K]
    (counted apart); `a` (with a GELU `act`) -> bf16(d * act'(a)); neither
    -> bf16(d). With `ln` the GEMM writes dh in f32 and `ln_pullback` takes
    it from there."""
    if not _on_cuda(dy):
        return _gemm_dgrad_ref(dy, w, a, act, ln)
    m, r = dy.shape
    k = w.shape[0]
    _check_dgrad_shape(m, r, k)
    if ln is not None and k > LN_PULLBACK_MAX_K:
        raise ValueError(f"gemm_dgrad's LN pullback needs K <= "
                         f"{LN_PULLBACK_MAX_K}; got K={k}")
    _mat(dy, "dy", (m, r), dy)
    _mat(w, "w", (k, r), dy)
    swiglu = act == ACT_SWIGLU and ln is None
    if ln is not None:  # dh in f32, for `ln_pullback`
        _mat(ln[0], "x", (m, k), dy)
        _mat(ln[1], "g", (m, k), dy)
        mode, a = _DGRAD_F32, None
        out = _f32((m, k), dy)
    else:
        mode = (_DGRAD_SWIGLU if swiglu else _DGRAD_PLAIN if a is None
                else _DGRAD_GELU)
        if a is not None:
            _mat(a, "h12" if swiglu else "a", (m, 2 * k if swiglu else k), dy)
        out = torch.empty((m, 2 * k if swiglu else k), dtype=dy.dtype,
                          device=dy.device)
    err = _build.lib().mst_gemm_dgrad(
        dy.data_ptr(), w.data_ptr(), out.data_ptr(), _ptr(a), m, r, k, mode,
        int(act), _stream(dy))
    _build.check(err, "mst_gemm_dgrad")
    _count(gemm_dgrad, "swiglu" if swiglu else None)
    return out if ln is None else ln_pullback(out, *ln)


def ln_pullback(dh, x, g, ln_s, eps):
    """The LN pullback plus the residual from dh [M, K] f32 (the row kernel
    after `gemm_dgrad`'s f32 product): x, g [M, K] ->
    (dx [M, K], dln_s [K] f32, dln_b [K] f32). One bandwidth-bound pass
    over the rows, then one fixed-order pass over its per-block column
    sums (`ln_pullback_launch`)."""
    if not _on_cuda(dh):
        return _ln_pullback_ref(dh, x, g, ln_s, eps)
    m, k = dh.shape
    _check_pullback_shape(m, k)
    if (dh.dtype != torch.float32 or not dh.is_contiguous()
            or dh.device != x.device or dh.data_ptr() % 16):
        raise ValueError(f"dh must be contiguous 16-byte aligned f32 on "
                         f"{x.device}")
    _mat(x, "x", (m, k), x)
    _mat(g, "g", (m, k), x)
    lns = _vec(ln_s, "ln_s", k, x)
    geo = ln_pullback_launch(m, k, _sms(x))
    out = torch.empty_like(x)
    work = _f32((geo.workspace // 4,), x)
    dlns, dlnb = _f32((k,), x), _f32((k,), x)
    err = _build.lib().mst_ln_pullback(
        dh.data_ptr(), x.data_ptr(), g.data_ptr(), lns.data_ptr(), float(eps),
        out.data_ptr(), work.data_ptr(), geo.workspace, dlns.data_ptr(),
        dlnb.data_ptr(), m, k, _stream(x))
    _build.check(err, "mst_ln_pullback")
    _count(ln_pullback)
    return out, dlns, dlnb


def mhsa_bwd(qkv, o, do, lse, n: int, s: int, num_heads: int, rope_cos=None,
             rope_sin=None):
    """Attention-core backward: the saved qkv [n*s, 3E], o [n*s, E] and lse
    [n*s, heads] with the upstream do [n*s, E] -> dqkv [n*s, 3E]. One call
    launches the dq kernel and then the dk/dv kernel. With the forward's
    RoPE tables the kernels rotate the pre-rope q and k and take dq and dk
    back through the rotation (counted apart)."""
    if not _on_cuda(qkv):
        return _mhsa_bwd_ref(qkv, o, do, lse, n, s, num_heads, rope_cos,
                             rope_sin)
    e = qkv.shape[1] // 3
    if e != 64 * num_heads or not 1 <= s <= MHSA_MAX_S:
        raise ValueError(f"mhsa_bwd needs head dim 64 and 1 <= S <= 512; got "
                         f"E={e}, heads={num_heads}, S={s}")
    _mat(qkv, "qkv", (n * s, 3 * e), qkv)
    _mat(o, "o", (n * s, e), qkv)
    _mat(do, "do", (n * s, e), qkv)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (n * s, num_heads)
            or not lse.is_contiguous() or lse.device != qkv.device):
        raise ValueError(f"lse must be contiguous f32 {(n * s, num_heads)} on "
                         f"{qkv.device}")
    rc, rs = _tables(rope_cos, rope_sin, s, qkv)
    dqkv = torch.empty_like(qkv)
    delta = _f32((n * s, num_heads), qkv)
    err = _build.lib().mst_mhsa_bwd(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), rc, rs, n, s, e, num_heads,
        1.0 / math.sqrt(64) * _LOG2E, 1.0 / math.sqrt(64), _stream(qkv))
    _build.check(err, "mst_mhsa_bwd")
    _count(mhsa_bwd, _rope_form(rope_cos))
    return dqkv


def fused_attention_sublayer(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                             num_heads, eps=1e-6):
    """y = x + ls * proj(MHSA(LN(x))) for x [N, S, E]."""
    if not (exporting() or _on_cuda(x)):
        return _attn_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                         num_heads, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = ln_gemm(x2, ln_s, ln_b, wqkv, bqkv, ACT_NONE, eps)
    o = mhsa(qkv, n, s, num_heads)
    y = gemm_residual(o, wproj, bproj, ls, x2)
    _called(fused_attention_sublayer, x)
    return y.reshape(n, s, e)


def fused_mlp_sublayer(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                       eps=1e-6):
    """y = x + ls * fc2(gelu(fc1(LN(x)))) for x [N, S, E]."""
    if not (exporting() or _on_cuda(x)):
        return _mlp_ref(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    h = ln_gemm(x2, ln_s, ln_b, w1, b1, act, eps)
    y = gemm_residual(h, w2, b2, ls, x2)
    _called(fused_mlp_sublayer, x)
    return y.reshape(n, s, e)


def fused_swiglu_sublayer(x, ln_s, ln_b, w12, b12, w3, b3, ls, eps=1e-6):
    """y = x + ls * w3(silu(h1) * h2), [h1 | h2] = w12(LN(x)), for x
    [N, S, E]: the giant2 FFN (`_swiglu_kernel`, serving only)."""
    if not (exporting() or _on_cuda(x)):
        return _swiglu_ref(x, ln_s, ln_b, w12, b12, w3, b3, ls, eps)
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    g = ln_gemm_swiglu(x2, ln_s, ln_b, w12, b12, eps)
    y = gemm_residual(g, w3, b3, ls, x2)
    _called(fused_swiglu_sublayer, x)
    return y.reshape(n, s, e)


# -- explainability sub-layers (serving only): the attention sub-layer with
# one more output of the attention core, read from the f32 probabilities
# inside `mhsa`'s block before they are cast for P.V ---------------------


def _attn_chain(mhsa_fn, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, eps,
                *mhsa_args, **mhsa_kw):
    """ln_gemm -> `mhsa_fn` -> gemm_residual: (y, *mhsa_fn's extra outputs)."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = ln_gemm(x2, ln_s, ln_b, wqkv, bqkv, ACT_NONE, eps)
    out = mhsa_fn(qkv, *mhsa_args, **mhsa_kw)
    o, *extra = out if isinstance(out, tuple) else (out,)
    y = gemm_residual(o, wproj, bproj, ls, x2)
    return (y.reshape(n, s, e), *extra)


def fused_attention_sublayer_rope(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                                  rope_cos, rope_sin, num_heads, eps=1e-6):
    """y = x + ls * proj(MHSA(RoPE(LN(x)))), the DINOv3 encoder's attention
    sub-layer (serving): rope_cos / rope_sin [S, head_dim] f32 in the
    interleaved-pair convention (prefix rows cos = 1, sin = 0)."""
    if not (exporting() or _on_cuda(x)):
        return _attn_rope_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                              rope_cos, rope_sin, num_heads, eps)
    n, s, _ = x.shape
    y, = _attn_chain(mhsa, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls, eps,
                     n, s, num_heads, rope_cos=rope_cos, rope_sin=rope_sin)
    _called(fused_attention_sublayer_rope, x)
    return y


def fused_attention_sublayer_rope_with_row(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                           bproj, ls, rope_cos, rope_sin,
                                           num_heads, eps=1e-6):
    """(y, cls_row) for the RoPE sub-layer: the DINOv3 block 11 of the
    `last` saliency mode under MST_NO_CHEAP_LAST."""
    if not (exporting() or _on_cuda(x)):
        return _attn_rope_with_row_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                       ls, rope_cos, rope_sin, num_heads, eps)
    n, s, _ = x.shape
    out = _attn_chain(mhsa_with_row, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                      ls, eps, n, s, num_heads, rope_cos=rope_cos,
                      rope_sin=rope_sin)
    _called(fused_attention_sublayer_rope_with_row, x)
    return out


def fused_attention_sublayer_with_row(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                      bproj, ls, num_heads, eps=1e-6):
    """(y, cls_row): the attention sub-layer plus the per-head CLS softmax
    row [N, heads, S] f32."""
    if not (exporting() or _on_cuda(x)):
        return _attn_with_row_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                                  num_heads, eps)
    n, s, _ = x.shape
    out = _attn_chain(mhsa_with_row, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                      ls, eps, n, s, num_heads)
    _called(fused_attention_sublayer_with_row, x)
    return out


def fused_attention_sublayer_abnar(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                   ls, num_heads, eps=1e-6, rope_cos=None,
                                   rope_sin=None):
    """(y, abnar_factor): the attention sub-layer plus this block's Abnar &
    Zuidema rollout factor [N, S, S] f32 (head-mean of the probabilities +
    I, row-normalised). `rope_cos` / `rope_sin`: the DINOv3 RoPE."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if not (exporting() or _on_cuda(x)):
        return _attn_abnar_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                               num_heads, eps, **rope)
    n, s, _ = x.shape
    out = _attn_chain(mhsa_abnar, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                      ls, eps, n, s, num_heads, **rope)
    _called(fused_attention_sublayer_abnar, x)
    return out


def fused_attention_sublayer_rollout(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                     ls, carry, num_heads, eps=1e-6,
                                     rope_cos=None, rope_sin=None,
                                     want_row=False):
    """(y, [cls_row,] new_carry): the attention sub-layer that also moves
    the rollout carry [N, heads, S] f32 (one-hot at token 0 before block 0)
    through this block's softmax, the CLS row of the reference
    `get_attention_cls` chain A_0 @ ... @ A_i. `rope_cos` / `rope_sin`: the
    DINOv3 RoPE."""
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    if not (exporting() or _on_cuda(x)):
        return _attn_rollout_ref(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                                 carry, num_heads, eps, want_row=want_row,
                                 **rope)
    n, s, _ = x.shape
    out = _attn_chain(mhsa_rollout, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                      ls, eps, carry, n, s, num_heads, want_row=want_row,
                      **rope)
    _called(fused_attention_sublayer_rollout, x)
    return out


# ---------------------------------------------------------------------------
# The serving kernels as registered ops (`torch.ops.mst_tpu_torch.*`), one
# per C entry point of the serving forward: the CUDA implementation is the
# launch above (which checks its operands and counts), the CPU one the
# plain version, the fake one the output's shape, dtype and strides (every
# output is contiguous). No backward is registered: they serve only.
# ---------------------------------------------------------------------------

_T = torch.Tensor


def _rows(h, n: int, dtype=None):
    return h.new_empty((h.shape[0], n), dtype=dtype or h.dtype)


@torch.library.custom_op("mst_tpu_torch::ln_rows", mutates_args=(),
                         device_types="cuda")
def _ln_rows_op(x: _T, ln_s: _T, ln_b: _T, eps: float) -> _T:
    return _ln_rows_cuda(x, ln_s, ln_b, eps)


_ln_rows_op.register_kernel("cpu")(_ln_rows_ref)
_ln_rows_op.register_fake(lambda x, ln_s, ln_b, eps: _rows(x, x.shape[1]))


@torch.library.custom_op("mst_tpu_torch::gemm_act", mutates_args=(),
                         device_types="cuda")
def _gemm_act_op(h: _T, w: _T, b: _T, act: int) -> _T:
    m, k = h.shape
    n = w.shape[1]
    _check_gemm_shape(m, k, n, gated=False)
    _mat(h, "h", (m, k), h)
    _mat(w, "w", (k, n), h)
    return _gemm_act_cuda(h, w, _vec(b, "bias", n, h), act)[0]


_gemm_act_op.register_kernel("cpu")(_gemm_act_ref)
_gemm_act_op.register_fake(lambda h, w, b, act: _rows(h, w.shape[1]))


@torch.library.custom_op("mst_tpu_torch::gemm_swiglu", mutates_args=(),
                         device_types="cuda")
def _gemm_swiglu_op(h: _T, w12: _T, b12: _T) -> _T:
    m, k = h.shape
    f2 = w12.shape[1]
    _check_swiglu_shape(m, k, f2)
    _mat(h, "h", (m, k), h)
    _mat(w12, "w12", (k, f2), h)
    return _gemm_swiglu_cuda(h, w12, _vec(b12, "b12", f2, h))[0]


_gemm_swiglu_op.register_kernel("cpu")(_gemm_swiglu_ref)
_gemm_swiglu_op.register_fake(lambda h, w12, b12: _rows(h, w12.shape[1] // 2))


@torch.library.custom_op("mst_tpu_torch::mhsa", mutates_args=(),
                         device_types="cuda")
def _mhsa_op(qkv: _T, carry: Optional[_T], rope_cos: Optional[_T],
             rope_sin: Optional[_T], n: int, s: int, num_heads: int,
             want_row: bool, want_abnar: bool) -> list[_T]:
    return _mhsa_cuda(qkv, carry, rope_cos, rope_sin, n, s, num_heads,
                      want_row, want_abnar)


@_mhsa_op.register_kernel("cpu")
def _(qkv, carry, rope_cos, rope_sin, n, s, num_heads, want_row, want_abnar):
    out = _mhsa_ref(qkv, n, s, num_heads, want_row=want_row, carry=carry,
                    want_abnar=want_abnar, rope_cos=rope_cos,
                    rope_sin=rope_sin)
    return list(out) if isinstance(out, tuple) else [out]


@_mhsa_op.register_fake
def _(qkv, carry, rope_cos, rope_sin, n, s, num_heads, want_row, want_abnar):
    f32 = dict(dtype=torch.float32)
    out = [_rows(qkv, qkv.shape[1] // 3)]
    if want_row:
        out.append(qkv.new_empty((n, num_heads, s), **f32))
    if want_abnar:
        out.append(qkv.new_empty((n, s, s), **f32))
    if carry is not None:
        out.append(qkv.new_empty((n, num_heads, s), **f32))
    return out


@torch.library.custom_op("mst_tpu_torch::gemm_residual", mutates_args=(),
                         device_types="cuda")
def _gemm_residual_op(a: _T, w: _T, b: _T, ls: Optional[_T], x: _T) -> _T:
    return _gemm_residual_cuda(a, w, b, ls, x)


_gemm_residual_op.register_kernel("cpu")(_gemm_residual_ref)
_gemm_residual_op.register_fake(lambda a, w, b, ls, x: _rows(x, w.shape[1]))


# ---------------------------------------------------------------------------
# Train sub-layers: residual-saving forward + hand-written backward
# ---------------------------------------------------------------------------

# The kernel wrappers (which take their plain versions on CPU tensors) and
# the plain versions alone, under one set of names: the train compositions
# below take one of them as `ops`.
KERNELS = SimpleNamespace(ln_gemm=ln_gemm, ln_gemm_swiglu=ln_gemm_swiglu,
                          mhsa=mhsa, gemm_residual=gemm_residual,
                          gemm_dls=gemm_dls, gemm_wgrad=gemm_wgrad,
                          gemm_dgrad=gemm_dgrad, mhsa_bwd=mhsa_bwd)
PLAIN = SimpleNamespace(ln_gemm=_ln_gemm_ref,
                        ln_gemm_swiglu=_ln_gemm_swiglu_ref, mhsa=_mhsa_ref,
                        gemm_residual=_gemm_residual_ref,
                        gemm_dls=_gemm_dls_ref, gemm_wgrad=_gemm_wgrad_ref,
                        gemm_dgrad=_gemm_dgrad_ref, mhsa_bwd=_mhsa_bwd_ref)


def _attn_train_fwd(ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                    num_heads, eps, rope_cos=None, rope_sin=None):
    """`_attn_train_kernel`: x [N, S, E] -> (y, residuals (h, qkv, o, lse));
    qkv is pre-rope, as in JAX."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv, h, _ = ops.ln_gemm(x2, ln_s, ln_b, wqkv, bqkv, ACT_NONE, eps,
                            train=True)
    o, lse = ops.mhsa(qkv, n, s, num_heads, want_lse=True, rope_cos=rope_cos,
                      rope_sin=rope_sin)
    y = ops.gemm_residual(o, wproj, bproj, ls, x2)
    return y.reshape(n, s, e), (h, qkv, o, lse)


def _attn_train_bwd(ops, g, x, res, ln_s, wqkv, wproj, bproj, ls, num_heads,
                    eps, rope_cos=None, rope_sin=None):
    """`_attn_bwd_kernel`: -> (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj,
    dls | None), the grads f32."""
    h, qkv, o, lse = res
    n, s, e = x.shape
    x2, g2 = x.reshape(n * s, e), g.reshape(n * s, e)
    gz, dls = (g2, None) if ls is None else ops.gemm_dls(o, wproj, bproj, ls,
                                                         g2)
    dwproj, dbproj = ops.gemm_wgrad(o, gz)
    do = ops.gemm_dgrad(gz, wproj)
    dqkv = ops.mhsa_bwd(qkv, o, do, lse, n, s, num_heads, rope_cos=rope_cos,
                        rope_sin=rope_sin)
    dwqkv, dbqkv = ops.gemm_wgrad(h, dqkv)
    dx, dlns, dlnb = ops.gemm_dgrad(dqkv, wqkv, ln=(x2, g2, ln_s, eps))
    return (dx.reshape(n, s, e), dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj,
            dls)


def _mlp_train_fwd(ops, x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate, eps):
    """`_mlp_train_kernel`: -> (y, residuals (h, a, u)); u = gelu(a) is the
    fc2 input the forward writes anyway, kept so that the backward needs no
    GELU pass of its own (JAX recomputes it; the values are the same)."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    a, h, u = ops.ln_gemm(x2, ln_s, ln_b, w1, b1, act, eps, train=True)
    y = ops.gemm_residual(u, w2, b2, ls, x2)
    return y.reshape(n, s, e), (h, a, u)


def _mlp_train_bwd(ops, g, x, res, ln_s, w1, w2, b2, ls, approximate, eps):
    """`_mlp_bwd_kernel`: -> (dx, dln_s, dln_b, dw1, db1, dw2, db2,
    dls | None), the grads f32."""
    h, a, u = res
    n, s, e = x.shape
    x2, g2 = x.reshape(n * s, e), g.reshape(n * s, e)
    act = ACT_GELU_TANH if approximate else ACT_GELU_ERF
    gz, dls = (g2, None) if ls is None else ops.gemm_dls(u, w2, b2, ls, g2)
    dw2, db2 = ops.gemm_wgrad(u, gz)
    da = ops.gemm_dgrad(gz, w2, a=a, act=act)
    dw1, db1 = ops.gemm_wgrad(h, da)
    dx, dlns, dlnb = ops.gemm_dgrad(da, w1, ln=(x2, g2, ln_s, eps))
    return dx.reshape(n, s, e), dlns, dlnb, dw1, db1, dw2, db2, dls


def _swiglu_train_fwd(ops, x, ln_s, ln_b, w12, b12, w3, b3, ls, eps):
    """`_swiglu_train_kernel`: -> (y, residuals (h, h12, g)); g = silu(h1)
    * h2 of the rounded h12 is the w3 input the forward writes anyway, kept
    so that the backward needs no gate pass of its own (JAX's XLA backward
    recomputes it from h12; the values are the same)."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    h12, h, g = ops.ln_gemm_swiglu(x2, ln_s, ln_b, w12, b12, eps, train=True)
    y = ops.gemm_residual(g, w3, b3, ls, x2)
    return y.reshape(n, s, e), (h, h12, g)


def _swiglu_train_bwd(ops, gout, x, res, ln_s, w12, w3, b3, ls, eps):
    """`_swiglu_train_bwd` on the kernels: -> (dx, dln_s, dln_b, dw12, db12,
    dw3, db3, dls | None), the grads f32."""
    h, h12, g = res
    n, s, e = x.shape
    x2, g2 = x.reshape(n * s, e), gout.reshape(n * s, e)
    gz, dls = (g2, None) if ls is None else ops.gemm_dls(g, w3, b3, ls, g2)
    dw3, db3 = ops.gemm_wgrad(g, gz)
    dh12 = ops.gemm_dgrad(gz, w3, a=h12, act=ACT_SWIGLU)
    dw12, db12 = ops.gemm_wgrad(h, dh12)
    dx, dlns, dlnb = ops.gemm_dgrad(dh12, w12, ln=(x2, g2, ln_s, eps))
    return dx.reshape(n, s, e), dlns, dlnb, dw12, db12, dw3, db3, dls


def _grads_like(grads, params):
    """Each grad in its parameter's shape and dtype (JAX's `_cast_like`)."""
    return tuple(None if p is None else gr.to(p.dtype).reshape(p.shape)
                 for gr, p in zip(grads, params))


class _AttnTrain(torch.autograd.Function):
    """`fused_attention_sublayer_train`'s custom VJP (and, with the RoPE
    tables, `fused_attention_sublayer_train_rope`'s). The matrices come in as
    the f32 parameters and are cast to x's dtype here, so their grads leave
    in f32 (a grad through the cast would be rounded to bf16 first). The
    tables are saved with the residuals and get no grad (constants of the
    patch grid; the JAX VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                num_heads, eps, rope_cos=None, rope_sin=None):
        x = x.detach()
        wq, wp = wqkv.detach().to(x.dtype), wproj.detach().to(x.dtype)
        y, res = _attn_train_fwd(ops, x, ln_s, ln_b, wq, bqkv, wp, bproj, ls,
                                 num_heads, eps, rope_cos, rope_sin)
        ctx.save_for_backward(x, *res, ln_s, ln_b, wq, bqkv, wp, bproj, ls,
                              wqkv, wproj, rope_cos, rope_sin)
        ctx.ops, ctx.num_heads, ctx.eps = ops, num_heads, eps
        return y

    @staticmethod
    def backward(ctx, g):
        (x, h, qkv, o, lse, ln_s, ln_b, wq, bqkv, wp, bproj, ls, wqkv,
         wproj, rope_cos, rope_sin) = ctx.saved_tensors
        dx, *grads = _attn_train_bwd(
            ctx.ops, g.to(x.dtype).contiguous(), x, (h, qkv, o, lse), ln_s,
            wq, wp, bproj, ls, ctx.num_heads, ctx.eps, rope_cos, rope_sin)
        grads = _grads_like(grads, (ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls))
        return (None, dx, *grads, None, None, None, None)


class _MlpTrain(torch.autograd.Function):
    """`fused_mlp_sublayer_train`'s custom VJP (as `_AttnTrain`)."""

    @staticmethod
    def forward(ctx, ops, x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                eps):
        x = x.detach()
        w1c, w2c = w1.detach().to(x.dtype), w2.detach().to(x.dtype)
        y, res = _mlp_train_fwd(ops, x, ln_s, ln_b, w1c, b1, w2c, b2, ls,
                                approximate, eps)
        ctx.save_for_backward(x, *res, ln_s, ln_b, w1c, b1, w2c, b2, ls, w1,
                              w2)
        ctx.ops, ctx.approximate, ctx.eps = ops, approximate, eps
        return y

    @staticmethod
    def backward(ctx, g):
        (x, h, a, u, ln_s, ln_b, w1c, b1, w2c, b2, ls, w1,
         w2) = ctx.saved_tensors
        dx, *grads = _mlp_train_bwd(
            ctx.ops, g.to(x.dtype).contiguous(), x, (h, a, u), ln_s, w1c, w2c,
            b2, ls, ctx.approximate, ctx.eps)
        grads = _grads_like(grads, (ln_s, ln_b, w1, b1, w2, b2, ls))
        return (None, dx, *grads, None, None)


class _SwigluTrain(torch.autograd.Function):
    """`fused_swiglu_sublayer_train`'s custom VJP (as `_AttnTrain`)."""

    @staticmethod
    def forward(ctx, ops, x, ln_s, ln_b, w12, b12, w3, b3, ls, eps):
        x = x.detach()
        w12c, w3c = w12.detach().to(x.dtype), w3.detach().to(x.dtype)
        y, res = _swiglu_train_fwd(ops, x, ln_s, ln_b, w12c, b12, w3c, b3, ls,
                                   eps)
        ctx.save_for_backward(x, *res, ln_s, ln_b, w12c, b12, w3c, b3, ls,
                              w12, w3)
        ctx.ops, ctx.eps = ops, eps
        return y

    @staticmethod
    def backward(ctx, gout):
        (x, h, h12, g, ln_s, ln_b, w12c, b12, w3c, b3, ls, w12,
         w3) = ctx.saved_tensors
        dx, *grads = _swiglu_train_bwd(
            ctx.ops, gout.to(x.dtype).contiguous(), x, (h, h12, g), ln_s,
            w12c, w3c, b3, ls, ctx.eps)
        grads = _grads_like(grads, (ln_s, ln_b, w12, b12, w3, b3, ls))
        return (None, dx, *grads, None)


def fused_attention_sublayer_train(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                   ls, num_heads, eps=1e-6, ops=KERNELS):
    """y = x + ls * proj(MHSA(LN(x))), differentiable in every argument
    through the saved-residual backward. `ops=PLAIN` runs the same
    composition on the plain versions (a reference on the card)."""
    y = _AttnTrain.apply(ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                         num_heads, eps)
    if ops is KERNELS and _on_cuda(x):
        fused_attention_sublayer_train.calls += 1
    return y


def fused_attention_sublayer_train_rope(x, ln_s, ln_b, wqkv, bqkv, wproj,
                                        bproj, ls, rope_cos, rope_sin,
                                        num_heads, eps=1e-6, ops=KERNELS):
    """The DINOv3 train sub-layer: `fused_attention_sublayer_train` with
    RoPE on q and k ([S, head_dim] f32 tables); the saved qkv is pre-rope
    and the backward recomputes the rotation and takes dq and dk back
    through it. No grad for the tables."""
    y = _AttnTrain.apply(ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                         num_heads, eps, rope_cos, rope_sin)
    if ops is KERNELS and _on_cuda(x):
        fused_attention_sublayer_train_rope.calls += 1
    return y


def fused_mlp_sublayer_train(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                             eps=1e-6, ops=KERNELS):
    """y = x + ls * fc2(gelu(fc1(LN(x)))), differentiable as
    `fused_attention_sublayer_train`."""
    y = _MlpTrain.apply(ops, x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                        eps)
    if ops is KERNELS and _on_cuda(x):
        fused_mlp_sublayer_train.calls += 1
    return y


def fused_swiglu_sublayer_train(x, ln_s, ln_b, w12, b12, w3, b3, ls,
                                eps=1e-6, ops=KERNELS):
    """y = x + ls * w3(silu(h1) * h2), [h1 | h2] = w12(LN(x)), the giant2
    FFN differentiable as `fused_attention_sublayer_train`: the forward
    saves h, h12 and the gate g (`_swiglu_train_kernel`), the backward is
    the kernel chain of `_swiglu_train_bwd`."""
    y = _SwigluTrain.apply(ops, x, ln_s, ln_b, w12, b12, w3, b3, ls, eps)
    if ops is KERNELS and _on_cuda(x):
        fused_swiglu_sublayer_train.calls += 1
    return y


# `.launches` of a kernel wrapper counts its kernel's launches and
# `.form_launches[form]` those of each of its forms (`<name>_<form>` in
# `launch_counts()`): the RoPE forms of the attention kernels, the train
# mode of `ln_gemm_swiglu` (queue B row 6) and the SiLU-gate epilogue of
# `gemm_dgrad`. `ln_rows` counts once per `ln_gemm` / `ln_gemm_swiglu`
# call (their LN half). The flash-attention wrappers of `ops/attention.py`
# (queue B rows 12-16, the composed path above 512 tokens, and its saliency
# outputs `flash_row`, `flash_carry`, `flash_abnar`) count here too.
# `.calls` of a sub-layer counts the calls that ran its kernel chain (it
# launches nothing itself). None moves on the CPU path. Through the
# registered ops a launch is counted where the op's CUDA implementation
# runs: in an uncaptured call of an exported program (and in a CUDA
# graph's warm-up and capture), not while `torch.export` traces and not
# when a captured graph is replayed.
KERNEL_WRAPPERS = (ln_rows, ln_gemm, mhsa, gemm_residual, gemm_dls,
                   gemm_wgrad, gemm_dgrad, mhsa_bwd, mhsa_with_row,
                   mhsa_rollout, mhsa_abnar, ln_gemm_swiglu, ln_pullback,
                   flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_row,
                   flash_carry, flash_abnar)
FORMS = {mhsa: ("rope",), mhsa_with_row: ("rope",), mhsa_rollout: ("rope",),
         mhsa_abnar: ("rope",), mhsa_bwd: ("rope",),
         ln_gemm_swiglu: ("train",), gemm_dgrad: ("swiglu",)}
SUBLAYER_WRAPPERS = (fused_attention_sublayer, fused_mlp_sublayer,
                     fused_swiglu_sublayer,
                     fused_attention_sublayer_train, fused_mlp_sublayer_train,
                     fused_swiglu_sublayer_train,
                     fused_attention_sublayer_with_row,
                     fused_attention_sublayer_rollout,
                     fused_attention_sublayer_abnar,
                     fused_attention_sublayer_rope,
                     fused_attention_sublayer_rope_with_row,
                     fused_attention_sublayer_train_rope)


def register_wrappers(kernels=(), sublayers=()) -> None:
    """Count another module's kernel wrappers and sub-layers with these (the
    int8 ones of `ops/fused_int8.py`, which imports this module)."""
    global KERNEL_WRAPPERS, SUBLAYER_WRAPPERS
    KERNEL_WRAPPERS += tuple(kernels)
    SUBLAYER_WRAPPERS += tuple(sublayers)
    reset_launch_counts()


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.form_launches = dict.fromkeys(FORMS.get(fn, ()), 0)
    for fn in SUBLAYER_WRAPPERS:
        fn.calls = 0


def launch_counts() -> dict:
    return {**{fn.__name__: fn.launches for fn in KERNEL_WRAPPERS},
            **{f"{fn.__name__}_{form}": n for fn in KERNEL_WRAPPERS
               for form, n in fn.form_launches.items()}}


def sublayer_calls() -> dict:
    return {fn.__name__: fn.calls for fn in SUBLAYER_WRAPPERS}


reset_launch_counts()
