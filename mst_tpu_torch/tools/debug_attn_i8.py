"""Diagnostic for `bench_attn_i8`: is each variant really computing?

Counterpart of `tools/debug_attn_i8.py` (queue B row 20; no kernel of its
own). One sub-layer (depth 1) of each variant of `bench_attn_i8` against a
plain mirror of the same math with f32 softmax attention (`plain_mirror`,
the JAX tool's `xla_ref`), as the relative error of the largest value; then
12 damped layers of the production bf16 `fused_attention_sublayer`
(weights dequantized, LN scale 8 / 8) timed beside variant A at the same
shape.

    python -m mst_tpu_torch.tools.debug_attn_i8
"""

from __future__ import annotations

import math

import torch

from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops import fused_int8 as fq
from mst_tpu_torch.tools import _common as c
from mst_tpu_torch.tools import bench_attn_i8 as bi

N, S, E, H = 32, 257, 384, 6
DEPTH = 12


def plain_mirror(x, p, num_heads: int):
    """The static int8 sub-layer with plain f32 softmax attention on the
    qkv rounded to x's dtype: LN -> clip(round) -> exact int8 product ->
    dequant -> softmax(q k^T / sqrt(64)) v -> clip(round(o)) -> int8 proj
    -> + x."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = fq._ln_gemm_i8_ref(x2, p.ln_s, p.ln_b, p.qkv.q8, p.qkv.scale,
                             p.qkv.bias, fb.ACT_NONE, bi.EPS, static=True)
    q, k, v = (fb._f(u) for u in c.head_views(qkv, n, s, 3, num_heads))
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c.HD), -1)
    o = c.merge_heads(att @ v, n, s)
    oq = fq._quant_static(o)
    return fq._gemm_i8_residual_ref(oq, None, p.proj.q8, p.proj.scale,
                                    p.proj.bias, None, x2).reshape(n, s, e)


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref| (the JAX tool's reading)."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-9)).item()


def production(x, p, num_heads: int, depth: int = DEPTH):
    """`depth` damped layers of the bf16 serving sub-layer on the
    dequantized weights (LN scale 8 / 8, no LayerScale)."""
    wq = (p.qkv.q8.float() * p.qkv.scale).to(torch.bfloat16)
    wp = (p.proj.q8.float() * p.proj.scale).to(torch.bfloat16)
    for _ in range(depth):
        x = fb.fused_attention_sublayer(x, p.ln_s / 8.0, p.ln_b, wq,
                                        p.qkv.bias, wp, p.proj.bias, None,
                                        num_heads, bi.EPS) * 0.5
    return x


def main() -> dict:
    """Print each variant's error against the mirror and the two 12-layer
    times; returns {"rel_<variant>": error, "production_ms": ..,
    "variant_a_ms": ..}."""
    dev = c.require_cuda()
    tag = c.card_tag()
    p = bi.params(dev, *bi.weights(E))
    x = bi.inputs(dev, N, S, E)
    res = {}
    with torch.inference_mode():
        ref = plain_mirror(x, p, H)
        print(f"{tag} mirror mean|x|={ref.float().abs().mean().item():.4f}")
        for v in bi.VARIANTS:
            out = bi.sublayer(x, p, H, v)
            res[f"rel_{v}"] = rel_err(out, ref)
            print(f"{tag} {v}: rel|out - mirror|={res[f'rel_{v}']:.4e}  "
                  f"mean|out|={out.float().abs().mean().item():.4f}")
        res["production_ms"] = c.time_ms(lambda: production(x, p, H))
        res["variant_a_ms"] = c.time_ms(lambda: bi.chain(x, p, H, "A", DEPTH))
    print(f"{tag} {DEPTH}-layer chain at [{N}, {S}, {E}]: production bf16 "
          f"{res['production_ms']:.4f} ms, variant A (int8) "
          f"{res['variant_a_ms']:.4f} ms")
    return res


if __name__ == "__main__":
    main()
