"""Experiment: the softmax form inside the attention sub-layer, on the card.

Counterpart of `tools/bench_attn_softmax.py` (queue B row 18). One
sub-layer is x -> qkv = x @ wqkv (no LayerNorm, no bias) -> per-head
softmax attention -> o @ wproj -> + x, in bf16 with f32 sums, chained
DEPTH times; five forms of the softmax:

  A  p = exp(s - m), P = p / l before the bf16 cast       (the TPU baseline)
  B  as A, the division applied to o instead of P
  C  log2(e) folded into the scale, exp2, P normalised as A
  D  C plus B: the shipped `mhsa` math
  E  D with s - m rounded to bf16 and the exponential taken in bf16

At head dim 64 a score costs 256 tensor-core FLOPs and one exponential, and
the H100 does ~250x more bf16 FLOPs than exponentials a second, so the
exponential's form is the H100 question. The core is
`csrc/attn_variants.cu`; the products are `csrc/gemm_residual.cu` (with and
without its residual).

    python -m mst_tpu_torch.tools.bench_attn_softmax
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops.attention import _on_cuda
from mst_tpu_torch.tools import _common as c

N, S, E, H = 128, 257, 384, 6
DEPTH = 12
VARIANTS = "ABCDE"
SEED = 0


def scale_of(variant: str) -> float:
    """The score scale of a variant: 1/sqrt(64), times log2(e) where the
    softmax takes exp2."""
    return (1.0 / math.sqrt(c.HD)) * (c.LOG2E if variant in "CDE" else 1.0)


def core_ref(qkv, n: int, s: int, num_heads: int, variant: str,
             want_p: bool = False, scale=None):
    """Plain attention core of `variant`: qkv [n*s, 3E] -> o [n*s, E]; with
    `want_p` also the P operand of P.V, [n, heads, s, s] in qkv's dtype.
    Rounding points of the JAX tool's `make_kernel`: s in f32; A / C: P =
    p / l, then cast; B / D / E: o = (P.V) / l, l the f32 sum of p; E: d =
    bf16(s - m), p = bf16(exp2(d)) from f32 exp2 of the bf16 argument."""
    dt = qkv.dtype
    q, k, v = c.head_views(qkv, n, s, 3, num_heads)
    sc = fb._mm(q, k.transpose(-1, -2)) * (scale_of(variant) if scale is None
                                           else scale)
    m = sc.amax(-1, keepdim=True)
    if variant == "E":
        p = torch.exp2(fb._f((sc - m).to(torch.bfloat16))).to(torch.bfloat16)
    elif variant in "CD":
        p = torch.exp2(sc - m)
    else:
        p = torch.exp(sc - m)
    if variant in "AC":
        pp = (p / p.sum(-1, keepdim=True)).to(dt)
        o = fb._mm(pp, v).to(dt)
    else:
        pp = p.to(dt)
        o = (fb._mm(pp, v) / fb._f(p).sum(-1, keepdim=True)).to(dt)
    o = c.merge_heads(o, n, s)
    return (o, pp) if want_p else o


def variant_launch(s: int) -> SimpleNamespace:
    """The launch geometry of `attn_variant` at sequence length s, as
    csrc/attn_variants.cu `mst_attn_variant_geometry` exports it: `mhsa`'s
    plan (64-query tiles, up to 5 walked by one block of one warpgroup, the
    grid heads x tile groups by slices; one pass up to S = 272; 64-key
    chunks and a 16-key tail), with the dynamic shared memory of 1 KB of
    alignment, two Q boxes, the K and V boxes and the barriers (no carry
    sums). Raises ValueError outside 1 <= S <= 512, before any launch."""
    if not 1 <= s <= fb.MHSA_MAX_S:
        raise ValueError(f"attn_variant takes 1 <= S <= {fb.MHSA_MAX_S}; "
                         f"got S={s}")
    g = fb.mhsa_launch(s)
    box, tail_box = 64 * c.HD * 2, 16 * c.HD * 2
    operand = g.chunks64 * box + g.tail16 * tail_box
    return SimpleNamespace(
        tile=g.tile, tiles=g.tiles, tiles_per_block=g.tiles_per_block,
        threads=g.threads, passes=g.passes, chunks64=g.chunks64,
        tail16=g.tail16,
        smem=1024 + 2 * box + 2 * operand + (2 + g.chunks64 + g.tail16) * 8)


def attn_variant(qkv, n: int, s: int, num_heads: int, variant: str,
                 want_p: bool = False, scale=None):
    """The attention core in softmax form `variant` (A-E): qkv [n*s, 3E]
    bf16 -> o [n*s, E]; with `want_p` also the bf16 P operand of P.V, [n,
    heads, s, s]. `scale` overrides the variant's score scale (a planted
    fault in the card's checks)."""
    if not _on_cuda(qkv):
        return core_ref(qkv, n, s, num_heads, variant, want_p, scale)
    e = qkv.shape[1] // 3
    if e != c.HD * num_heads:
        raise ValueError(f"attn_variant needs head dim 64; got E={e}, "
                         f"heads={num_heads}")
    variant_launch(s)
    fb._mat(qkv, "qkv", (n * s, 3 * e), qkv)
    out = torch.empty((n * s, e), dtype=qkv.dtype, device=qkv.device)
    p = (torch.empty((n, num_heads, s, s), dtype=qkv.dtype,
                     device=qkv.device) if want_p else None)
    err = _build.lib().mst_attn_variant(
        qkv.data_ptr(), out.data_ptr(), fb._ptr(p), n, s, e, num_heads,
        VARIANTS.index(variant),
        scale_of(variant) if scale is None else scale, fb._stream(qkv))
    _build.check(err, "mst_attn_variant")
    attn_variant.launches += 1
    return (out, p) if want_p else out


fb.register_wrappers(kernels=(attn_variant,))


def sublayer(x, wqkv, wproj, num_heads: int, variant: str):
    """One layer of the tool: bf16(x + attn(bf16(x @ wqkv)) @ wproj), x [n,
    s, E]. On CUDA: `gemm` -> `attn_variant` -> `gemm_residual`."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = c.gemm(x2, wqkv)
    o = attn_variant(qkv, n, s, num_heads, variant)
    return c.residual(o, wproj, x2).reshape(n, s, e)


def chain(x, wqkv, wproj, num_heads: int, variant: str, depth: int = DEPTH):
    for _ in range(depth):
        x = sublayer(x, wqkv, wproj, num_heads, variant)
    return x


def inputs(device, n=N, s=S, e=E, seed=SEED, dtype=torch.bfloat16):
    """The tool's operands: x ~ N(0, 1), wqkv and wproj ~ 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return (c.tensor(c.normal(rng, (n, s, e)), device, dtype),
            c.tensor(c.normal(rng, (e, 3 * e), 0.05), device, dtype),
            c.tensor(c.normal(rng, (e, e), 0.05), device, dtype))


def flops(n=N, s=S, e=E, depth=DEPTH) -> float:
    """The chain's product FLOPs (qkv, scores, P.V, proj)."""
    return depth * n * (2 * s * e * 3 * e + 2 * s * s * e * 2 + 2 * s * e * e)


def main() -> dict:
    """Time each variant's chain at the tool's shape; returns {variant:
    ms}."""
    dev = c.require_cuda()
    tag = c.card_tag()
    x, wqkv, wproj = inputs(dev)
    times = {}
    with torch.inference_mode():
        ref = chain(x, wqkv, wproj, H, "A")
        for v in VARIANTS:
            ms = c.time_ms(lambda: chain(x, wqkv, wproj, H, v))
            out = chain(x, wqkv, wproj, H, v)
            err = (out.float() - ref.float()).abs().max().item()
            times[v] = ms
            print(f"{tag} softmax {v}: {ms:.4f} ms for {DEPTH} layers at "
                  f"[{N}, {S}, {E}] ({flops() / ms / 1e9:.2f} TFLOP/s), "
                  f"{times['A'] / ms:.3f}x A, max|out - A|={err:.4g}")
    return times


if __name__ == "__main__":
    main()
