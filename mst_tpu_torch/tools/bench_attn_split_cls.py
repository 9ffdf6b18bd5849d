"""Experiment: the split-CLS attention layout against the shipped one.

Counterpart of `tools/bench_attn_split_cls.py` (queue B row 21). S = 257 =
CLS + 256 patches. The shipped `mhsa` runs 5 query tiles of 64 rows per
(slice, head) over keys padded to 272, so the fifth tile holds one valid
row. The split layout runs the 256 patch queries in 4 exact tiles over the
256 patch keys, takes the CLS key as a strip (one 64-wide dot per row) and
the CLS query row in a second, one-warp-per-(slice, head) kernel.

Only the attention core, qkv [N*S, 3E] -> o [N*S, E], is timed, DEPTH
launches on the same qkv (the JAX tool fed its [N, S, E] output back into a
kernel that reads [N, S, 3E], past the end of the array; this chain does
not). base is `csrc/attn_variants.cu` variant D, the math of `mhsa`;
split is that file's split kernels.

    python -m mst_tpu_torch.tools.bench_attn_split_cls
"""

from __future__ import annotations

import math

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


def attn_split_cls(qkv, n: int, s: int, num_heads: int, scale: float = SCALE):
    """The split-CLS core: qkv [n*s, 3E] bf16 -> o [n*s, E], s - 1 a
    multiple of 64. One call launches the patch kernel and the CLS-row
    kernel."""
    if not _on_cuda(qkv):
        return split_ref(qkv, n, s, num_heads, scale)
    e = qkv.shape[1] // 3
    if e != c.HD * num_heads or (s - 1) % 64:
        raise ValueError(f"attn_split_cls needs head dim 64 and S - 1 % 64 "
                         f"== 0; got E={e}, heads={num_heads}, S={s}")
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
