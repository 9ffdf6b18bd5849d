"""Experiment: one ViT block in 3 launches against the shipped 5.

Counterpart of `tools/bench_block_fusion.py` (queue B row 17), at its
shape: N = 128 slices of S = 257 tokens, E = 384, 6 heads, FF = 1536, 12
blocks, bf16, no LayerScale.

  split  the shipped layout: `fused_attention_sublayer` (`ln_gemm` ->
         `mhsa` -> `gemm_residual`) then `fused_mlp_sublayer` (`ln_gemm`
         with GELU -> `gemm_residual`), 5 launches a block
  block  `ln_gemm` (LN1 + qkv) -> `mhsa` -> `block_tail`
         (`csrc/block_tail.cu`: proj, residual, LN2, fc1, GELU, fc2,
         residual in one launch, TMA + wgmma: a persistent CTA an SM walks
         units of 64 rows, fc1 -> fc2 fused per hidden chunk of 128
         columns), 3 launches a block

The TPU ran each block as one program per slice; on the H100 a slice's qkv
does not fit a thread block's shared memory and attention needs the whole
slice, so the fusion stops at the attention core. The plain block follows
the JAX tool's `_attn_half` / `_mlp_half`, which rounds fc1 + b1 to bf16
before the GELU (the shipped `ln_gemm` rounds once, after it).

    python -m mst_tpu_torch.tools.bench_block_fusion
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as fb
from mst_tpu_torch.ops.attention import _on_cuda
from mst_tpu_torch.tools import _common as c

N, S, E, H = 128, 257, 384, 6
FF = 4 * E
DEPTH = 12
EPS = 1e-6
SEED = 0
TAIL_ROWS = 64  # rows of a block_tail unit
TAIL_CHUNK = 128  # hidden columns of a chunk (64 a consumer warpgroup)
TAIL_KB = 64  # k rows of a block_tail weight box (three a ring stage)


def mlp_half_ref(x2, ln_s, ln_b, w1, b1, w2, b2, eps: float = EPS):
    """The tool's `_mlp_half` on rows x2 [M, E]: bf16(x + gelu_tanh(bf16(
    bf16(LN(x)) @ w1 + b1)) @ w2 + b2), each product summed in f32."""
    dt = x2.dtype
    h = fb._ln(x2, ln_s, ln_b, eps).to(dt)
    pre = (fb._mm(h, w1) + fb._f(b1)).to(dt)
    a = fb._gelu(fb._f(pre), True).to(dt)
    return (fb._f(x2) + (fb._mm(a, w2) + fb._f(b2))).to(dt)


def block_tail_ref(o, x2, wproj, bproj, ln_s, ln_b, w1, b1, w2, b2,
                   eps: float = EPS):
    """x1 = bf16(x + o @ wproj + bproj), then `mlp_half_ref(x1)`."""
    x1 = fb._gemm_residual_ref(o, wproj, bproj, None, x2)
    return mlp_half_ref(x1, ln_s, ln_b, w1, b1, w2, b2, eps)


def block_tail_launch(m: int, sms: int = fb.H100_SMS) -> SimpleNamespace:
    """The launch geometry of `block_tail` at m rows on a card of `sms`
    SMs, as csrc/block_tail.cu `mst_block_tail_geometry` exports it: units
    of 64 whole rows walked by persistent CTAs (one an SM, or one a unit)
    of two consumer warpgroups and a producer warpgroup; each consumer's
    ring holds 48 KB of stages of three [TAIL_KB][64] weight boxes; a unit
    takes E / TAIL_KB proj stages and, for each of the 12 hidden chunks,
    E / (3 TAIL_KB) fc1 and 128 / TAIL_KB fc2 stages; dynamic shared
    memory of 1 KB of alignment, the o / h and x / x1 tiles (48 KB each),
    two chunk buffers (16 KB each), the two rings and their barriers.
    Raises ValueError where the kernel would."""
    if m < 1 or sms < 1:
        raise ValueError(f"block_tail needs M >= 1; got M={m}")
    units = -(-m // TAIL_ROWS)
    stage = 3 * TAIL_KB * 64 * 2
    ring = 48 * 1024 // stage
    unit_stages = E // TAIL_KB + (FF // TAIL_CHUNK) * (
        E // (3 * TAIL_KB) + TAIL_CHUNK // TAIL_KB)
    smem = (1024 + 2 * E * 64 * 2 + 2 * TAIL_CHUNK * 64 * 2 + 2 * ring * stage
            + (2 + 4 * ring) * 8)
    return SimpleNamespace(rows=TAIL_ROWS, units=units, grid=min(units, sms),
                           threads=3 * 128, consumers=2, ring=ring,
                           stage=stage, unit_stages=unit_stages, smem=smem)


def block_tail(o, x2, wproj, bproj, ln_s, ln_b, w1, b1, w2, b2,
               eps: float = EPS):
    """Everything of a block after its attention core, in one launch: o, x2
    [M, 384] bf16 -> [M, 384] (`block_tail_ref`'s rounding points)."""
    if not _on_cuda(x2):
        return block_tail_ref(o, x2, wproj, bproj, ln_s, ln_b, w1, b1, w2, b2,
                              eps)
    m, e = x2.shape
    f = w1.shape[1]
    if (e, f) != (E, FF):
        raise ValueError(f"block_tail is built for E={E}, F={FF}; got E={e},"
                         f" F={f}")
    block_tail_launch(m)
    for t, name, shape in ((o, "o", (m, e)), (x2, "x", (m, e)),
                           (wproj, "wproj", (e, e)), (w1, "w1", (e, f)),
                           (w2, "w2", (f, e))):
        fb._mat(t, name, shape, x2)
    vecs = [fb._vec(t, name, n, x2) for t, name, n in (
        (bproj, "bproj", e), (ln_s, "ln_s", e), (ln_b, "ln_b", e),
        (b1, "b1", f), (b2, "b2", e))]
    out = torch.empty_like(x2)
    err = _build.lib().mst_block_tail(
        o.data_ptr(), x2.data_ptr(), wproj.data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), vecs[2].data_ptr(), w1.data_ptr(),
        vecs[3].data_ptr(), w2.data_ptr(), vecs[4].data_ptr(), out.data_ptr(),
        m, e, f, float(eps), fb._stream(x2))
    _build.check(err, "mst_block_tail")
    block_tail.launches += 1
    return out


fb.register_wrappers(kernels=(block_tail,))


def params(device, e: int = E, seed: int = SEED, dtype=torch.bfloat16):
    """The tool's block: LN scales 1, biases 0, weights ~ 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return c.tensor(c.normal(rng, shape, 0.05), device, dtype)

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    return SimpleNamespace(
        ln1s=const(e, 1.0), ln1b=const(e, 0.0), wqkv=w(e, 3 * e),
        bqkv=const(3 * e, 0.0), wproj=w(e, e), bproj=const(e, 0.0),
        ln2s=const(e, 1.0), ln2b=const(e, 0.0), w1=w(e, 4 * e),
        b1=const(4 * e, 0.0), w2=w(4 * e, e), b2=const(e, 0.0))


def inputs(device, n=N, s=S, e=E, seed=SEED, dtype=torch.bfloat16):
    """The tool's activations: x ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed + 1)
    return c.tensor(c.normal(rng, (n, s, e), 0.3), device, dtype)


def block_ref(x, p, num_heads: int = H):
    """The plain block: the tool's `_attn_half` then `_mlp_half`."""
    n, s, e = x.shape
    y = fb._attn_ref(x, p.ln1s, p.ln1b, p.wqkv, p.bqkv, p.wproj, p.bproj,
                     None, num_heads, EPS).reshape(n * s, e)
    return mlp_half_ref(y, p.ln2s, p.ln2b, p.w1, p.b1, p.w2,
                        p.b2).reshape(n, s, e)


def split_block(x, p, num_heads: int = H):
    """The shipped layout: the attention and MLP sub-layers, 5 launches."""
    y = fb.fused_attention_sublayer(x, p.ln1s, p.ln1b, p.wqkv, p.bqkv,
                                    p.wproj, p.bproj, None, num_heads, EPS)
    return fb.fused_mlp_sublayer(y, p.ln2s, p.ln2b, p.w1, p.b1, p.w2, p.b2,
                                 None, True, EPS)


def fused_block(x, p, num_heads: int = H):
    """`ln_gemm` -> `mhsa` -> `block_tail`, 3 launches."""
    n, s, e = x.shape
    x2 = x.reshape(n * s, e)
    qkv = fb.ln_gemm(x2, p.ln1s, p.ln1b, p.wqkv, p.bqkv, fb.ACT_NONE, EPS)
    o = fb.mhsa(qkv, n, s, num_heads)
    return block_tail(o, x2, p.wproj, p.bproj, p.ln2s, p.ln2b, p.w1, p.b1,
                      p.w2, p.b2).reshape(n, s, e)


LAYOUTS = {"split": lambda x, p, nh: split_block(x, p, nh),
           "block": lambda x, p, nh: fused_block(x, p, nh)}


def chain(x, p, layout: str, depth: int = DEPTH, num_heads: int = H):
    block = block_ref if layout == "plain" else LAYOUTS[layout]
    for _ in range(depth):
        x = block(x, p, num_heads)
    return x


def main() -> dict:
    """Time both layouts' 12-block chains, interleaved twice; returns
    {layout: [ms, ms]}."""
    dev = c.require_cuda()
    tag = c.card_tag()
    p = params(dev)
    x = inputs(dev)
    times = {"split": [], "block": []}
    with torch.inference_mode():
        diff = (chain(x, p, "split", 1).float()
                - chain(x, p, "block", 1).float()).abs().max().item()
        print(f"{tag} max|split - block| = {diff:.4g} (one block)")
        for layout in ("split", "block") * 2:
            ms = c.time_ms(lambda: chain(x, p, layout))
            times[layout].append(ms)
            print(f"{tag} {layout}: {ms:.4f} ms for {DEPTH} blocks at "
                  f"[{N}, {S}, {E}]")
    return times


if __name__ == "__main__":
    main()
