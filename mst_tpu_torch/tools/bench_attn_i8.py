"""Experiment: int8 attention scores and context in the W8A8 attention
sub-layer.

Counterpart of `tools/bench_attn_i8.py` (queue B row 19). The static int8
sub-layer (scales folded: LN scale 8, dequantization scales 2e-3) keeps the
softmax attention in bf16 on the dequantized q / k / v; here its products
may run on the int8 tensor cores too:

  A  bf16 attention: the shipped static chain, `ln_gemm_i8` -> `mhsa` ->
     `quant_rows` -> `gemm_i8_residual`
  B  int8 scores: q and k requantized (codes of the f32 qkv, clip(round)),
     s = int32(qq . kq^T) * scale, softmax in f32, context in bf16
  C  B plus int8 context: v requantized, p = exp2(s - m + log2 127) in
     [0, 127] rounded to codes, o = int32(pq . vq) / l

The codes of q, k (and v) come from `ln_gemm_i8`'s int8 output with a unit
`a_inv`; the core of B and C is `csrc/attn_i8.cu`. DEPTH damped layers (h
* 0.5 between them: a bf16 residual stream that outgrows its updates
becomes a fixed point) are timed at three shapes.

    python -m mst_tpu_torch.tools.bench_attn_i8
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops import fused_int8 as fq
from mst_tpu_torch.ops.attention import _on_cuda
from mst_tpu_torch.tools import _common as c

DEPTH = 24
EPS = 1e-6
SCALE = 1.0 / math.sqrt(c.HD) * c.LOG2E
LOG2_127 = math.log2(127.0)
VARIANTS = "ABC"
SEED = 0
# (label, N, S, E, heads): the tool's three shapes
SHAPES = (
    ("ViT-S/14 224 (S=257, E=384, h=6), N=256", 256, 257, 384, 6),
    ("DINOv3-S/16 224 (S=201, E=384, h=6), N=256", 256, 201, 384, 6),
    ("giant2 (S=257, E=1536, h=24), N=32", 32, 257, 1536, 24),
)


def core_i8_ref(q8, v, n: int, s: int, num_heads: int, out_dtype,
                scale: float = SCALE):
    """Plain int8 attention core: q8 holds the codes of q | k (variant B,
    v [n*s, E] in the working dtype) or of q | k | v (variant C, v None);
    -> o [n*s, E] in `out_dtype`. The integer products are exact (f64)."""
    wd = torch.float64 if out_dtype == torch.float64 else torch.float32
    parts = 2 if v is not None else 3
    t = c.head_views(q8, n, s, parts, num_heads)
    qq, kq = (u.to(torch.float64) for u in t[:2])
    sc = torch.matmul(qq, kq.transpose(-1, -2)).to(wd) * scale
    m = sc.amax(-1, keepdim=True)
    if v is not None:
        p = torch.exp2(sc - m)
        (vh,) = c.head_views(v, n, s, 1, num_heads)
        o = fb._mm(p.to(v.dtype), vh) / p.sum(-1, keepdim=True)
    else:
        p = torch.exp2((sc - m) + LOG2_127)
        pq = torch.round(p)
        o = (torch.matmul(pq.to(torch.float64), t[2].to(torch.float64))
             .to(wd) / p.sum(-1, keepdim=True))
    return c.merge_heads(o.to(out_dtype), n, s)


def i8_launch(s: int, variant: str) -> SimpleNamespace:
    """The launch geometry of `attn_i8` at sequence length s in variant B
    or C, as csrc/attn_i8.cu `mst_attn_i8_geometry` exports it: `mhsa`'s
    plan (64-query tiles, up to 5 walked by one block of one warpgroup, the
    grid heads x tile groups by slices; one pass up to S = 272; 64-key
    chunks and a 16-key tail), C's transposed V codes `vt` [64][vt_ld]
    (the chunks' keys rounded up to 32, + 16 bytes), and the dynamic
    shared memory: 1 KB of alignment, two 4 KB Q boxes of codes, the 8 KB
    output staging box, the K code boxes, the V boxes (codes for C, bf16
    for B), C's vt, the barriers. Raises ValueError outside 1 <= S <= 512,
    before any launch."""
    if not 1 <= s <= fb.MHSA_MAX_S:
        raise ValueError(f"attn_i8 takes 1 <= S <= {fb.MHSA_MAX_S}; got "
                         f"S={s}")
    g = fb.mhsa_launch(s)
    keys = g.chunks64 * 64 + g.tail16 * 16
    codes = g.chunks64 * 64 * c.HD + g.tail16 * 16 * c.HD
    vt_ld = (-(-keys // 32) * 32 + 16) if variant == "C" else 0
    v_bytes = codes if variant == "C" else 2 * codes
    return SimpleNamespace(
        tile=g.tile, tiles=g.tiles, tiles_per_block=g.tiles_per_block,
        threads=g.threads, passes=g.passes, chunks64=g.chunks64,
        tail16=g.tail16, vt_ld=vt_ld,
        smem=(1024 + 2 * 64 * c.HD + 64 * c.HD * 2 + codes + v_bytes
              + c.HD * vt_ld + (2 + g.chunks64 + g.tail16) * 8))


def attn_i8(q8, v, n: int, s: int, num_heads: int, scale: float = SCALE,
            out_dtype=torch.bfloat16, *, want_p: bool = False):
    """The int8 attention core: variant B with v [n*s, E] bf16 and q8 the
    codes [n*s, 2E] of q | k, or variant C with v None and q8 the codes
    [n*s, 3E] of q | k | v -> o [n*s, E] in `out_dtype` (bf16 on CUDA).
    `scale` overrides the score scale (a planted fault in the card's
    checks). On CUDA `want_p` (variant C only) also returns the int8 codes
    of P that the kernel's P.V reads, [n, heads, s, s] (the card's
    checks)."""
    if not _on_cuda(q8):
        return core_i8_ref(q8, v, n, s, num_heads, out_dtype, scale)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"attn_i8 writes bf16 on CUDA, not {out_dtype}")
    e = c.HD * num_heads
    parts = 2 if v is not None else 3
    i8_launch(s, "B" if v is not None else "C")
    if want_p and v is not None:
        raise ValueError("attn_i8 returns P for variant C only (its codes)")
    fq._codes(q8, "q8", (n * s, parts * e), q8)
    if v is not None:
        fb._mat(v, "v", (n * s, e), q8)
    out = torch.empty((n * s, e), dtype=torch.bfloat16, device=q8.device)
    p = (torch.empty((n, num_heads, s, s), device=q8.device,
                     dtype=torch.int8) if want_p else None)
    err = _build.lib().mst_attn_i8(
        q8.data_ptr(), fb._ptr(v), out.data_ptr(), fb._ptr(p), n, s, e,
        num_heads, 1 if v is not None else 2, scale, fb._stream(q8))
    _build.check(err, "mst_attn_i8")
    attn_i8.launches += 1
    return (out, p) if want_p else out


fb.register_wrappers(kernels=(attn_i8,))


def weights(e: int, seed: int = SEED):
    """The tool's int8 wqkv [e, 3e] and wproj [e, e], uniform in [-127,
    127] (numpy)."""
    rng = np.random.default_rng(seed)
    return c.codes(rng, (e, 3 * e)), c.codes(rng, (e, e))


def params(device, wqkv, wproj):
    """The tool's static int8 sub-layer on the int8 codes wqkv / wproj
    (numpy): LN scale 8 (the folded activation scale), LN bias 0, scales
    2e-3, zero biases; `qk` / `v` are wqkv's column blocks (variant B)."""
    e = wproj.shape[0]

    def dense(q8, cols):
        return SimpleNamespace(
            q8=c.tensor(q8, device), q8t=c.tensor(q8.T, device), a_inv=None,
            scale=torch.full((cols,), 2e-3, device=device),
            bias=torch.zeros(cols, device=device))

    return SimpleNamespace(
        ln_s=torch.full((e,), 8.0, device=device),
        ln_b=torch.zeros(e, device=device),
        qkv=dense(wqkv, 3 * e), qk=dense(wqkv[:, :2 * e], 2 * e),
        v=dense(wqkv[:, 2 * e:], e), proj=dense(wproj, e),
        one=torch.ones(1, device=device))


def inputs(device, n: int, s: int, e: int, seed: int = SEED,
           dtype=torch.bfloat16):
    """The tool's activations: x ~ 4 N(0, 1)."""
    rng = np.random.default_rng(seed + 1)
    return c.tensor(c.normal(rng, (n, s, e), 4.0), device, dtype)


def _ln_i8(x2, p, dense, codes: bool):
    """`ln_gemm_i8` (static) of one of p's products: the bf16 qkv, or with
    `codes` its int8 codes clip(round(qkv))."""
    return fq.ln_gemm_i8(x2, p.ln_s, p.ln_b, dense.q8, dense.scale,
                         dense.bias, fb.ACT_NONE, EPS, static=True,
                         a_inv=p.one if codes else None, q8t=dense.q8t)


def sublayer(x, p, num_heads: int, variant: str, scale: float = SCALE):
    """One static W8A8 attention sub-layer of `variant` (A, B or C), x [n,
    s, E] -> [n, s, E]; the proj is `quant_rows` (static) ->
    `gemm_i8_residual` on the bf16 o."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    if variant == "A":
        o = fb.mhsa(_ln_i8(x2, p, p.qkv, False), n, s, num_heads)
    elif variant == "B":
        o = attn_i8(_ln_i8(x2, p, p.qk, True), _ln_i8(x2, p, p.v, False), n,
                    s, num_heads, scale, x.dtype)
    else:
        o = attn_i8(_ln_i8(x2, p, p.qkv, True), None, n, s, num_heads, scale,
                    x.dtype)
    oq = fq.quant_rows(o, static=True)
    y = fq.gemm_i8_residual(oq, None, p.proj.q8, p.proj.scale, p.proj.bias,
                            None, x2, q8t=p.proj.q8t)
    return y.reshape(n, s, e)


def chain(x, p, num_heads: int, variant: str, depth: int = DEPTH):
    """`depth` damped layers: h = sublayer(h) * 0.5."""
    for _ in range(depth):
        x = sublayer(x, p, num_heads, variant) * 0.5
    return x


def macs(n: int, s: int, e: int, depth: int = DEPTH) -> float:
    """Multiply-adds of the chain: qkv + proj + scores + context."""
    return depth * n * (s * e * 4 * e + 2 * s * s * e)


def main() -> dict:
    """Time each variant's chain at each shape; returns {(label, variant):
    ms}."""
    dev = c.require_cuda()
    tag = c.card_tag()
    times = {}
    with torch.inference_mode():
        for label, n, s, e, nh in SHAPES:
            p = params(dev, *weights(e))
            x = inputs(dev, n, s, e)
            print(f"{tag} {label}")
            for v in VARIANTS:
                ms = c.time_ms(lambda: chain(x, p, nh, v), n=5, warmup=1)
                times[(label, v)] = ms
                print(f"{tag}   {v}: {ms:.4f} ms for {DEPTH} layers "
                      f"({2 * macs(n, s, e) / ms / 1e9:.2f} TFLOP/s-equiv)"
                      f", {times[(label, 'A')] / ms:.3f}x A")
    return times


if __name__ == "__main__":
    main()
