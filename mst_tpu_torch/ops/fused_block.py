"""Fused ViT sub-layers on hand-written Hopper kernels.

Counterpart of `mst_tpu/ops/fused_block.py` (plain flags):

- `fused_attention_sublayer`: y = x + ls1 * proj(MHSA(LN1(x)))
- `fused_mlp_sublayer`:       y = x + ls2 * fc2(gelu(fc1(LN2(x))))
- `fused_attention_sublayer_train` / `fused_mlp_sublayer_train`: the same
  forwards as `torch.autograd.Function`s that save residuals (qkv, o, the
  base-2 log-sum-exp rows; the pre-activation) and run a hand-written
  backward from them, never the forward again (the JAX `custom_vjp`s).

On the TPU each is one Pallas program that keeps a slice's whole [S, E]
block and the layer's weights in VMEM. An H100 SM has 227 KB of shared
memory, so each sub-layer here is a short chain of CUDA kernels
(`mst_tpu_torch/csrc/`):

- attention: `ln_gemm` (LN + qkv) -> `mhsa` -> `gemm_residual` (proj + ls + x)
- MLP:       `ln_gemm` (LN + fc1 + GELU) -> `gemm_residual` (fc2 + ls + x)
- backward:  `gemm_dls` (ls grad), `gemm_wgrad` (weight and bias grads),
  `gemm_dgrad` (input grads, with the GELU' or the LN-pullback epilogue),
  `mhsa_bwd` (dq, dk, dv), chained by `_attn_train_bwd` / `_mlp_train_bwd`

Every kernel wrapper dispatches on the device of the tensor it is given: a
CUDA tensor launches the kernel (bf16 only) and counts the launch; a CPU
tensor takes the kernel's plain PyTorch version, which rounds to the
working dtype at the same points as the kernel and the Pallas body (qkv
after its bias, P before P.V, o / l, the GELU output, the residual sum in
f32; in the train bodies also the pre-activation before its GELU, gz, do,
p before dv, ds, dq / dk / dv, da). There is no fallback from one to the
other. Each train sub-layer composes the kernel wrappers through an `ops`
table (`KERNELS`), so the CPU runs the same composition on the plain
versions, and `PLAIN` runs it on the plain versions on any device.

Argument conventions follow the JAX package: x [N, S, E]; matrices in the
flax Dense layout [in, out]; LN scale / bias, biases and LayerScale as
vectors (used in f32); `ls=None` means no LayerScale.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

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


def _ln_gemm_ref(x, ln_s, ln_b, w, b, act: int, eps: float,
                 train: bool = False):
    h = _ln(x, ln_s, ln_b, eps).to(x.dtype)
    y = _mm(h, w) + b.float()
    if train:  # (pre-activation, h, act of the rounded pre-activation)
        pre = y.to(x.dtype)
        post = None if act == ACT_NONE else _gelu(
            pre.float(), act == ACT_GELU_TANH).to(x.dtype)
        return pre, h, post
    if act != ACT_NONE:
        y = _gelu(y, act == ACT_GELU_TANH)
    return y.to(x.dtype)


def _mhsa_ref(qkv, n: int, s: int, num_heads: int, want_lse: bool = False):
    e = qkv.shape[1] // 3
    hd = e // num_heads
    dt = qkv.dtype
    t = qkv.reshape(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [n, heads, s, hd]
    sc = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd) * _LOG2E)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp2(sc - m)
    l = p.sum(-1, keepdim=True)
    o = (_mm(p.to(dt), v) / l).to(dt)
    o = o.permute(0, 2, 1, 3).reshape(n * s, e)
    if not want_lse:
        return o
    # base-2 log-sum-exp in the scaled units, [n * s, heads] (JAX's [N, S, H])
    lse = (m + torch.log2(l))[..., 0].permute(0, 2, 1).reshape(n * s, num_heads)
    return o, lse.contiguous()


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


# -- plain versions of the backward kernels (`_attn_bwd_kernel`,
# `_mlp_bwd_kernel` in mst_tpu/ops/fused_block.py, step by step) ----------


def _ln_recompute(x, eps):
    """LN statistics recomputed from x in f32 -> (xhat, rstd)."""
    xf = x.float()
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
    gf = g.float()
    z = _mm(a, w) + b.float()
    return (gf * ls.float()).to(g.dtype), (gf * z).sum(0)


def _gemm_wgrad_ref(a, b):
    """(a^T @ b, column sums of b), both f32."""
    return _mm(a.t(), b), b.float().sum(0)


def _gemm_dgrad_ref(dy, w, a=None, act: int = ACT_NONE, ln=None):
    """dy @ w^T (f32), then: with `ln` = (x, g, ln_s, eps) the LN pullback
    plus the residual -> (dx, dln_s, dln_b); with `a` the GELU' epilogue ->
    bf16(d * act'(a)); else d in dy's dtype."""
    d = _mm(dy, w.t())
    if ln is not None:
        x, g, ln_s, eps = ln
        xhat, rstd = _ln_recompute(x, eps)
        dxhat = d * ln_s.float()
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (rstd * (dxhat - m1 - xhat * m2) + g.float()).to(x.dtype)
        return dx, (d * xhat).sum(0), d.sum(0)
    if a is not None:
        return (d * _act_grad(a.float(), act)).to(dy.dtype)
    return d.to(dy.dtype)


def _mhsa_bwd_ref(qkv, o, do, lse, n: int, s: int, num_heads: int):
    """dqkv [n*s, 3E] from the saved qkv, o, lse and the upstream do:
    p = exp2(s - b) rebuilt from the log-sum-exp rows, delta = rowdot(do, o)."""
    e = qkv.shape[1] // 3
    hd = e // num_heads
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(hd)
    t = qkv.reshape(n, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [n, heads, s, hd]

    def heads(u):
        return u.reshape(n, s, num_heads, hd).permute(0, 2, 1, 3)

    do_h, o_h = heads(do), heads(o)
    b = lse.reshape(n, s, num_heads).permute(0, 2, 1)[..., None]
    p = torch.exp2(_mm(q, k.transpose(-1, -2)) * (scale * _LOG2E) - b)
    dv = _mm(p.to(dt).transpose(-1, -2), do_h).to(dt)
    dp = _mm(do_h, v.transpose(-1, -2))
    delta = (do_h.float() * o_h.float()).sum(-1, keepdim=True)
    ds = ((dp - delta) * p * scale).to(dt)
    dq = _mm(ds, k).to(dt)
    dk = _mm(ds.transpose(-1, -2), q).to(dt)
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
    """A parameter vector as the kernels read it: [n] f32, contiguous, on
    the device of `like` (the JAX package's `_vec`)."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} elements, expected {n}")
    return t.detach().reshape(n).to(torch.float32).contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f32(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def ln_gemm(x, ln_s, ln_b, w, b, act: int, eps: float, train: bool = False):
    """act(LN(x) @ w + b): x [M, K], w [K, N] -> [M, N]. With `train`:
    (pre, h, post) = (bf16(LN(x) @ w + b), bf16(LN(x)), bf16(act(pre)) or
    None for ACT_NONE), the residuals of `_attn_train_kernel` /
    `_mlp_train_kernel`."""
    if not _on_cuda(x):
        return _ln_gemm_ref(x, ln_s, ln_b, w, b, act, eps, train)
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
    h = post = None
    if train:
        h = torch.empty_like(x)
        if act != ACT_NONE:
            post = torch.empty_like(out)
    err = _build.lib().mst_ln_gemm(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
        b.data_ptr(), out.data_ptr(), _ptr(h), _ptr(post), m, k, n,
        float(eps), int(act), _stream(x))
    _build.check(err, "mst_ln_gemm")
    ln_gemm.launches += 1
    return (out, h, post) if train else out


def mhsa(qkv, n: int, s: int, num_heads: int, want_lse: bool = False):
    """Per-slice softmax attention: qkv [n*s, 3E] -> o [n*s, E]; with
    `want_lse` also the base-2 log-sum-exp rows [n*s, heads] f32."""
    if not _on_cuda(qkv):
        return _mhsa_ref(qkv, n, s, num_heads, want_lse)
    e = qkv.shape[1] // 3
    if e != 64 * num_heads or s > 512:
        raise ValueError(f"mhsa needs head dim 64 and S <= 512; got "
                         f"E={e}, heads={num_heads}, S={s}")
    _mat(qkv, "qkv", (n * s, 3 * e), qkv)
    out = torch.empty((n * s, e), dtype=qkv.dtype, device=qkv.device)
    lse = _f32((n * s, num_heads), qkv) if want_lse else None
    err = _build.lib().mst_mhsa(
        qkv.data_ptr(), out.data_ptr(), _ptr(lse), n, s, e, num_heads,
        1.0 / math.sqrt(64) * _LOG2E, _stream(qkv))
    _build.check(err, "mst_mhsa")
    mhsa.launches += 1
    return (out, lse) if want_lse else out


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
    if k % 32 or n % 128:
        raise ValueError(f"gemm_dls needs K % 32 == 0 and N % 128 == 0; got "
                         f"K={k}, N={n}")
    _mat(a, "a", (m, k), g)
    _mat(w, "w", (k, n), g)
    _mat(g, "g", (m, n), g)
    b, ls = _vec(b, "bias", n, g), _vec(ls, "ls", n, g)
    gz = torch.empty_like(g)
    dls = _f32((n,), g)
    work = _f32((-(-m // 64), n), g)
    err = _build.lib().mst_gemm_dls(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), ls.data_ptr(), g.data_ptr(),
        gz.data_ptr(), work.data_ptr(), dls.data_ptr(), m, k, n, _stream(g))
    _build.check(err, "mst_gemm_dls")
    gemm_dls.launches += 1
    return gz, dls


# Target blocks of one gemm_wgrad launch: its [K, N] output is only 9-72
# tiles of 64 x 128 at ViT-S, so the M rows are split to fill the 132 SMs a
# few blocks deep.
_WGRAD_BLOCKS = 1056


def gemm_wgrad(a, b):
    """Weight and bias grads: a [M, K], b [M, N] -> (a^T @ b [K, N] f32,
    column sums of b [N] f32)."""
    if not _on_cuda(b):
        return _gemm_wgrad_ref(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k % 64 or n % 128:
        raise ValueError(f"gemm_wgrad needs K % 64 == 0 and N % 128 == 0; "
                         f"got K={k}, N={n}")
    _mat(a, "a", (m, k), b)
    _mat(b, "b", (m, n), b)
    tiles = (k // 64) * (n // 128)
    splits = max(1, min(-(-_WGRAD_BLOCKS // tiles), -(-m // 256)))
    rows = -(-(-(-m // splits)) // 32) * 32
    splits = -(-m // rows)
    dw, db = _f32((k, n), b), _f32((n,), b)
    work = _f32((splits * (k * n + n),), b)
    err = _build.lib().mst_gemm_wgrad(
        a.data_ptr(), b.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), m, k, n, rows, _stream(b))
    _build.check(err, "mst_gemm_wgrad")
    gemm_wgrad.launches += 1
    return dw, db


def gemm_dgrad(dy, w, a=None, act: int = ACT_NONE, ln=None):
    """Input grad of a Dense layer, dy [M, R] @ w[K, R]^T, f32 accumulated,
    with the epilogue of `_gemm_dgrad_ref`: `ln` = (x, g, ln_s, eps) ->
    (dx, dln_s, dln_b); `a` (with `act`) -> bf16(d * act'(a)); neither ->
    bf16(d)."""
    if not _on_cuda(dy):
        return _gemm_dgrad_ref(dy, w, a, act, ln)
    m, r = dy.shape
    k = w.shape[0]
    if r % 32 or k % 128 or (ln is not None and k != 384):
        raise ValueError(f"gemm_dgrad needs R % 32 == 0 and K % 128 == 0 (K "
                         f"== 384 with the LN epilogue); got R={r}, K={k}")
    _mat(dy, "dy", (m, r), dy)
    _mat(w, "w", (k, r), dy)
    out = torch.empty((m, k), dtype=dy.dtype, device=dy.device)
    x = g = lns = work = dlns = dlnb = None
    eps = 0.0
    if ln is not None:
        x, g, lns, eps = ln
        _mat(x, "x", (m, k), dy)
        _mat(g, "g", (m, k), dy)
        lns = _vec(lns, "ln_s", k, dy)
        work = _f32((2 * -(-m // 32), k), dy)
        dlns, dlnb = _f32((k,), dy), _f32((k,), dy)
    elif a is not None:
        _mat(a, "a", (m, k), dy)
    err = _build.lib().mst_gemm_dgrad(
        dy.data_ptr(), w.data_ptr(), out.data_ptr(), m, r, k,
        _ptr(None if ln is not None else a), int(act), _ptr(x), _ptr(g),
        _ptr(lns), float(eps), _ptr(work), _ptr(dlns), _ptr(dlnb),
        _stream(dy))
    _build.check(err, "mst_gemm_dgrad")
    gemm_dgrad.launches += 1
    return (out, dlns, dlnb) if ln is not None else out


def mhsa_bwd(qkv, o, do, lse, n: int, s: int, num_heads: int):
    """Attention-core backward: the saved qkv [n*s, 3E], o [n*s, E] and lse
    [n*s, heads] with the upstream do [n*s, E] -> dqkv [n*s, 3E]. One call
    launches the dq kernel and then the dk/dv kernel."""
    if not _on_cuda(qkv):
        return _mhsa_bwd_ref(qkv, o, do, lse, n, s, num_heads)
    e = qkv.shape[1] // 3
    if e != 64 * num_heads or s > 512:
        raise ValueError(f"mhsa_bwd needs head dim 64 and S <= 512; got "
                         f"E={e}, heads={num_heads}, S={s}")
    _mat(qkv, "qkv", (n * s, 3 * e), qkv)
    _mat(o, "o", (n * s, e), qkv)
    _mat(do, "do", (n * s, e), qkv)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (n * s, num_heads)
            or not lse.is_contiguous() or lse.device != qkv.device):
        raise ValueError(f"lse must be contiguous f32 {(n * s, num_heads)} on "
                         f"{qkv.device}")
    dqkv = torch.empty_like(qkv)
    delta = _f32((n * s, num_heads), qkv)
    err = _build.lib().mst_mhsa_bwd(
        qkv.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), n, s, e, num_heads,
        1.0 / math.sqrt(64) * _LOG2E, 1.0 / math.sqrt(64), _stream(qkv))
    _build.check(err, "mst_mhsa_bwd")
    mhsa_bwd.launches += 1
    return dqkv


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


# ---------------------------------------------------------------------------
# Train sub-layers: residual-saving forward + hand-written backward
# ---------------------------------------------------------------------------

# The kernel wrappers (which take their plain versions on CPU tensors) and
# the plain versions alone, under one set of names: the train compositions
# below take one of them as `ops`.
KERNELS = SimpleNamespace(ln_gemm=ln_gemm, mhsa=mhsa,
                          gemm_residual=gemm_residual, gemm_dls=gemm_dls,
                          gemm_wgrad=gemm_wgrad, gemm_dgrad=gemm_dgrad,
                          mhsa_bwd=mhsa_bwd)
PLAIN = SimpleNamespace(ln_gemm=_ln_gemm_ref, mhsa=_mhsa_ref,
                        gemm_residual=_gemm_residual_ref,
                        gemm_dls=_gemm_dls_ref, gemm_wgrad=_gemm_wgrad_ref,
                        gemm_dgrad=_gemm_dgrad_ref, mhsa_bwd=_mhsa_bwd_ref)


def _attn_train_fwd(ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                    num_heads, eps):
    """`_attn_train_kernel`: x [N, S, E] -> (y, residuals (h, qkv, o, lse))."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv, h, _ = ops.ln_gemm(x2, ln_s, ln_b, wqkv, bqkv, ACT_NONE, eps,
                            train=True)
    o, lse = ops.mhsa(qkv, n, s, num_heads, want_lse=True)
    y = ops.gemm_residual(o, wproj, bproj, ls, x2)
    return y.reshape(n, s, e), (h, qkv, o, lse)


def _attn_train_bwd(ops, g, x, res, ln_s, wqkv, wproj, bproj, ls, num_heads,
                    eps):
    """`_attn_bwd_kernel`: -> (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj,
    dls | None), the grads f32."""
    h, qkv, o, lse = res
    n, s, e = x.shape
    x2, g2 = x.reshape(n * s, e), g.reshape(n * s, e)
    gz, dls = (g2, None) if ls is None else ops.gemm_dls(o, wproj, bproj, ls,
                                                         g2)
    dwproj, dbproj = ops.gemm_wgrad(o, gz)
    do = ops.gemm_dgrad(gz, wproj)
    dqkv = ops.mhsa_bwd(qkv, o, do, lse, n, s, num_heads)
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


def _grads_like(grads, params):
    """Each grad in its parameter's shape and dtype (JAX's `_cast_like`)."""
    return tuple(None if p is None else gr.to(p.dtype).reshape(p.shape)
                 for gr, p in zip(grads, params))


class _AttnTrain(torch.autograd.Function):
    """`fused_attention_sublayer_train`'s custom VJP. The matrices come in as
    the f32 parameters and are cast to x's dtype here, so their grads leave
    in f32 (a grad through the cast would be rounded to bf16 first)."""

    @staticmethod
    def forward(ctx, ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls,
                num_heads, eps):
        x = x.detach()
        wq, wp = wqkv.detach().to(x.dtype), wproj.detach().to(x.dtype)
        y, res = _attn_train_fwd(ops, x, ln_s, ln_b, wq, bqkv, wp, bproj, ls,
                                 num_heads, eps)
        ctx.save_for_backward(x, *res, ln_s, ln_b, wq, bqkv, wp, bproj, ls,
                              wqkv, wproj)
        ctx.ops, ctx.num_heads, ctx.eps = ops, num_heads, eps
        return y

    @staticmethod
    def backward(ctx, g):
        (x, h, qkv, o, lse, ln_s, ln_b, wq, bqkv, wp, bproj, ls, wqkv,
         wproj) = ctx.saved_tensors
        dx, *grads = _attn_train_bwd(
            ctx.ops, g.to(x.dtype).contiguous(), x, (h, qkv, o, lse), ln_s,
            wq, wp, bproj, ls, ctx.num_heads, ctx.eps)
        grads = _grads_like(grads, (ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls))
        return (None, dx, *grads, None, None)


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


def fused_mlp_sublayer_train(x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                             eps=1e-6, ops=KERNELS):
    """y = x + ls * fc2(gelu(fc1(LN(x)))), differentiable as
    `fused_attention_sublayer_train`."""
    y = _MlpTrain.apply(ops, x, ln_s, ln_b, w1, b1, w2, b2, ls, approximate,
                        eps)
    if ops is KERNELS and _on_cuda(x):
        fused_mlp_sublayer_train.calls += 1
    return y


# `.launches` of a kernel wrapper counts its kernel's launches; `.calls` of a
# sub-layer counts the calls that ran its kernel chain (it launches nothing
# itself). Neither moves on the CPU path.
KERNEL_WRAPPERS = (ln_gemm, mhsa, gemm_residual, gemm_dls, gemm_wgrad,
                   gemm_dgrad, mhsa_bwd)
SUBLAYER_WRAPPERS = (fused_attention_sublayer, fused_mlp_sublayer,
                     fused_attention_sublayer_train, fused_mlp_sublayer_train)


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
