"""Experiment: the split-CLS attention layout against the shipped one.

Counterpart of `tools/bench_attn_split_cls.py` (queue B row 21). S = 257 =
CLS + 256 patches. The shipped `mhsa` runs 5 query tiles of 64 rows per
(slice, head) over 4 key chunks of 64 and a 16-key tail, so the fifth tile
holds one valid row. The split layout (`csrc/attn_variants.cu`
`split_cls_kernel`, TMA + wgmma) runs the 256 patch queries in 4 exact
tiles over the 256 patch keys in 4 exact boxes, takes the CLS key as a
strip (one 64-wide f32 dot per row) and, in the same launch, the CLS query
row from the K and V boxes already in shared memory.

Only the attention core, qkv [N*S, 3E] -> o [N*S, E], is timed, DEPTH
launches on the same qkv (the JAX tool fed its [N, S, E] output back into a
kernel that reads [N, S, 3E], past the end of the array; this chain does
not). base is `csrc/attn_variants.cu` variant D, the math of `mhsa`;
split is that file's split-CLS kernel.

    python -m mst_tpu_torch.tools.bench_attn_split_cls
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
from mst_tpu_torch.tools.bench_attn_softmax import attn_variant

N, S, E, H = 128, 257, 384, 6
DEPTH = 12
SEED = 0
SCALE = 1.0 / math.sqrt(c.HD) * c.LOG2E
MAX_P = 384  # the longest patch run the kernel takes
ONE_PASS_P = 256  # P.V from the registers of one pass up to here
# the kernel's f32 area: CLS key, value, query (64 each), the CLS row's
# probabilities (MAX_P + 8), four warps' P.V partials (4 x 64), 8 sums
F32_BYTES = 4 * (3 * c.HD + MAX_P + 8 + 4 * c.HD + 8)


def split_ref(qkv, n: int, s: int, num_heads: int, scale: float = SCALE):
    """Plain split-CLS core (`_mhsa_split` of the JAX tool): patch rows
    over the patch keys plus an f32 CLS strip, o_p = (bf16(p_pp) . v_p +
    p_pc * v_c) / l; the CLS row over all keys, o_c = (bf16(p_c) . v) /
    sum p_c."""
    dt = qkv.dtype
    q, k, v = c.head_views(qkv, n, s, 3, num_heads)
    qp, qc = q[..., 1:, :], q[..., :1, :]
    kp, kc = k[..., 1:, :], k[..., :1, :]
    vp, vc = v[..., 1:, :], v[..., :1, :]
    s_pp = fb._mm(qp, kp.transpose(-1, -2)) * scale
    s_pc = (fb._f(qp) * fb._f(kc)).sum(-1, keepdim=True) * scale
    m = torch.maximum(s_pp.amax(-1, keepdim=True), s_pc)
    p_pp = torch.exp2(s_pp - m)
    p_pc = torch.exp2(s_pc - m)
    l = p_pp.sum(-1, keepdim=True) + p_pc
    o_p = (fb._mm(p_pp.to(dt), vp) + p_pc * fb._f(vc)) / l
    s_c = fb._mm(qc, k.transpose(-1, -2)) * scale
    p_c = torch.exp2(s_c - s_c.amax(-1, keepdim=True))
    o_c = fb._mm(p_c.to(dt), v) / p_c.sum(-1, keepdim=True)
    return c.merge_heads(torch.cat([o_c, o_p], dim=-2).to(dt), n, s)


def split_launch(s: int) -> SimpleNamespace:
    """The launch geometry of `attn_split_cls` at sequence length s, as
    csrc/attn_variants.cu `mst_attn_split_cls_geometry` exports it: s = 1 +
    P with P a multiple of 64 from 64 to 384; P / 64 exact patch query
    tiles of 64 rows, up to 5 walked by one block of one warpgroup (the
    grid heads x tile groups by slices; the block of group 0 also takes the
    CLS row); P / 64 key boxes of 64 patch rows; one pass up to P = 256;
    dynamic shared memory of 1 KB of alignment, two Q boxes, the K and V
    boxes, the f32 area and the barriers. Raises ValueError at any other
    s, before any launch."""
    p = s - 1
    if p < 64 or p % 64 or p > MAX_P:
        raise ValueError(f"attn_split_cls takes S = 1 + P, P a multiple of 64 "
                         f"from 64 to {MAX_P}; got S={s}")
    tiles = p // 64
    blocks = -(-tiles // 5)
    box = 64 * c.HD * 2
    return SimpleNamespace(
        tile=64, tiles=tiles, tiles_per_block=-(-tiles // blocks),
        threads=128, passes=1 if p <= ONE_PASS_P else 2, boxes=tiles,
        smem=1024 + 2 * box + 2 * tiles * box + F32_BYTES + (2 + tiles) * 8)


def attn_split_cls(qkv, n: int, s: int, num_heads: int, scale: float = SCALE):
    """The split-CLS core: qkv [n*s, 3E] bf16 -> o [n*s, E], s = 1 + P with
    P a multiple of 64 from 64 to 384 (`split_launch`). One launch: the
    patch tiles, then the CLS rows."""
    if not _on_cuda(qkv):
        return split_ref(qkv, n, s, num_heads, scale)
    e = qkv.shape[1] // 3
    if e != c.HD * num_heads:
        raise ValueError(f"attn_split_cls needs head dim 64; got E={e}, "
                         f"heads={num_heads}")
    split_launch(s)
    fb._mat(qkv, "qkv", (n * s, 3 * e), qkv)
    out = torch.empty((n * s, e), dtype=qkv.dtype, device=qkv.device)
    err = _build.lib().mst_attn_split_cls(
        qkv.data_ptr(), out.data_ptr(), n, s, e, num_heads, scale,
        fb._stream(qkv))
    _build.check(err, "mst_attn_split_cls")
    attn_split_cls.launches += 1
    return out


fb.register_wrappers(kernels=(attn_split_cls,))

# each looks its kernel wrapper up when called
LAYOUTS = {
    "base": lambda qkv, n, s, nh: attn_variant(qkv, n, s, nh, "D"),
    "split": lambda qkv, n, s, nh: attn_split_cls(qkv, n, s, nh),
}


def chain(qkv, layout: str, n=N, s=S, num_heads=H, depth: int = DEPTH):
    """DEPTH launches of one layout's core on the same qkv; the last o."""
    for _ in range(depth):
        o = LAYOUTS[layout](qkv, n, s, num_heads)
    return o


def inputs(device, n=N, s=S, e=E, seed=SEED, dtype=torch.bfloat16):
    """The tool's operand: qkv ~ 0.3 N(0, 1), [n*s, 3E]."""
    rng = np.random.default_rng(seed)
    return c.tensor(c.normal(rng, (n * s, 3 * e), 0.3), device, dtype)


def flops(n=N, s=S, num_heads=H, depth=DEPTH) -> float:
    """The chain's score and P.V FLOPs (the tool's count)."""
    return n * depth * num_heads * 2 * 2 * s * s * c.HD


def main() -> dict:
    """Time both layouts' chains; returns {layout: ms}."""
    dev = c.require_cuda()
    tag = c.card_tag()
    qkv = inputs(dev)
    times = {}
    with torch.inference_mode():
        diff = (chain(qkv, "base", depth=1).float()
                - chain(qkv, "split", depth=1).float()).abs().max().item()
        print(f"{tag} max|base - split| = {diff:.4g}")
        for layout in ("base", "split"):
            ms = c.time_ms(lambda: chain(qkv, layout))
            times[layout] = ms
            print(f"{tag} {layout}: {ms:.4f} ms for {DEPTH} cores at "
                  f"[{N}, {S}, {3 * E}] ({flops() / ms / 1e9:.2f} TFLOP/s "
                  f"on score + P.V FLOPs)")
    return times


if __name__ == "__main__":
    main()
