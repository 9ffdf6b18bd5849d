"""Slice-fusion transformer: attention with the rotary options, encoder
layer.

Counterpart of `mst_tpu/models/slice_fusion.py` (`MultiheadAttention`,
`TransformerEncoderLayer`), computed the way the fused serving path
computes it (`mst_tpu/models/vit_fast.py` `_fused_mst`): the fusion
sequence is one CLS token plus D slice features, so it stays plain PyTorch;
the FLOPs live in the per-slice encoder. The attention takes the rotary
options of the JAX module (:74-89): RoPE over the head dim (theta 256,
interleaved pairs) or LiRE, learned skew-symmetric generators
`liere_generators [n_blocks, b(b-1)/2]` with blocks of b = max(hd // 2, 2)
head features, both applied to q and k after the head split. The layer is
pre-norm (`norm_first`, what the MST models build) or post-norm, with a
ReLU or GELU FFN, and torch's LN eps 1e-5.

`dtype` of a forward is the compute dtype of its products and norms (flax
`dtype=`); the residual stream keeps the input's dtype, as in flax, where
an f32 stream (MST-ResNet's pooled slice features) adds bf16 branches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mst_tpu_torch.models.layers import Dense, LayerNorm
from mst_tpu_torch.ops.attention import NEG_INF
from mst_tpu_torch.ops.fused_block import _f, _ln
from mst_tpu_torch.ops.rotary import (
    apply_liere,
    apply_rope,
    liere_rotations,
    num_skew_params,
    rope_angles,
)

ROTARY = (None, "RoPE", "LiRE")
FUSION_ROPE_THETA = 256.0  # the reference MHA's RoPE theta


class MultiheadAttention(nn.Module):
    """Packed-qkv attention parameters: in_proj [E, 3E], out_proj [E, E],
    and with LiRE `liere_generators` [n_blocks, b(b-1)/2]."""

    def __init__(self, dim: int, num_heads: int,
                 rotary: Optional[str] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads "
                             f"{num_heads}")
        if rotary not in ROTARY:
            raise ValueError(f"unknown rotary mode {rotary!r}")
        self.num_heads = num_heads
        self.rotary = rotary
        self.in_proj = Dense(dim, 3 * dim)
        self.out_proj = Dense(dim, dim)
        if rotary == "LiRE":
            hd = dim // num_heads
            self.liere_block = max(hd // 2, 2)
            self.liere_generators = nn.Parameter(torch.zeros(
                hd // self.liere_block, num_skew_params(self.liere_block)))

    def _rotate(self, q, k):
        s, hd = q.shape[-2], q.shape[-1]
        if self.rotary == "RoPE":
            ang = rope_angles(s, hd, FUSION_ROPE_THETA).to(q.device)
            return apply_rope(q, ang), apply_rope(k, ang)
        rots = liere_rotations(self.liere_generators,
                               torch.arange(s, device=q.device),
                               self.liere_block)
        return apply_liere(q, rots), apply_liere(k, rots)

    def forward(self, x, key_padding_mask: Optional[torch.Tensor] = None,
                want_probs: bool = False, dtype=None):
        """x [b, s, e] -> out in `dtype` (default x's), or (out, probs [b,
        heads, s, s] f32) with `want_probs` (the saliency path's
        `fusion_probs`; padded keys at -1e30)."""
        dt = x.dtype if dtype is None else dtype
        b, s, e = x.shape
        nh = self.num_heads
        hd = e // nh
        qkv = self.in_proj(x.to(dt)).reshape(b, s, 3, nh, hd).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [b, nh, s, hd]
        if self.rotary is not None:
            q, k = self._rotate(q, k)
        sc = torch.matmul(_f(q), _f(k).transpose(-1, -2)) * (
            1.0 / math.sqrt(hd))
        if key_padding_mask is not None:
            sc = sc.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.matmul(_f(p.to(dt)), _f(v)).to(dt)
        o = self.out_proj(o.permute(0, 2, 1, 3).reshape(b, s, e))
        return (o, p) if want_probs else o


class TransformerEncoderLayer(nn.Module):
    """Encoder layer: pre-norm x + SA(LN1 x), then x + FFN(LN2 x), or
    post-norm LN1(x + SA(x)), then LN2(x + FFN(x)); the FFN linear1 ->
    ReLU | GELU (tanh, flax's `nn.gelu`) -> linear2."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", norm_first: bool = True,
                 rotary: Optional[str] = None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.norm_first = norm_first
        self.self_attn = MultiheadAttention(d_model, nhead, rotary)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, 1e-5)
        self.norm2 = LayerNorm(d_model, 1e-5)

    def _ff(self, h):
        h = self.linear1(h)
        h = (torch.relu(h) if self.activation == "relu"
             else torch.nn.functional.gelu(h, approximate="tanh"))
        return self.linear2(h)

    def forward(self, x, key_padding_mask: Optional[torch.Tensor] = None,
                want_probs: bool = False, dtype=None):
        """-> x, or (x, attention probs) with `want_probs`; `dtype` the
        compute dtype (default x's)."""
        dt = x.dtype if dtype is None else dtype

        def norm(ln, h):
            return _ln(h, ln.scale, ln.bias, ln.eps).to(dt)

        def sa(h):
            return self.self_attn(h, key_padding_mask, True, dt)

        if self.norm_first:
            a, probs = sa(norm(self.norm1, x))
            x = x + a
            x = x + self._ff(norm(self.norm2, x))
        else:
            a, probs = sa(x)
            x = norm(self.norm1, x + a)
            x = norm(self.norm2, x + self._ff(x.to(dt)))
        return (x, probs) if want_probs else x
