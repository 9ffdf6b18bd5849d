"""Slice-fusion transformer layer (pre-norm, ReLU FFN, no rotary).

Counterpart of `mst_tpu/models/slice_fusion.py` `TransformerEncoderLayer`
as the MST classifier instantiates it, computed the way the fused serving
path computes it (`mst_tpu/models/vit_fast.py` `_fused_mst`): the fusion
sequence is one CLS token plus D slice features, so it stays plain PyTorch;
the FLOPs live in the per-slice encoder. Rotary (RoPE / LiRE) fusion is
ROADMAP queue A #9.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mst_tpu_torch.models.layers import Dense, LayerNorm
from mst_tpu_torch.ops.attention import NEG_INF
from mst_tpu_torch.ops.fused_block import _f


class MultiheadAttention(nn.Module):
    """Packed-qkv attention parameters: in_proj [E, 3E], out_proj [E, E]."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.in_proj = Dense(dim, 3 * dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, x, key_padding_mask: Optional[torch.Tensor] = None,
                want_probs: bool = False):
        """-> out, or (out, probs [b, heads, s, s] f32) with `want_probs`
        (the saliency path's `fusion_probs`; padded keys at -1e30)."""
        b, s, e = x.shape
        nh = self.num_heads
        hd = e // nh
        qkv = self.in_proj(x).reshape(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [b, nh, s, hd]
        sc = torch.matmul(_f(q), _f(k).transpose(-1, -2)) * (
            1.0 / math.sqrt(hd))
        if key_padding_mask is not None:
            sc = sc.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.matmul(_f(p.to(x.dtype)), _f(v)).to(x.dtype)
        o = self.out_proj(o.permute(0, 2, 1, 3).reshape(b, s, e))
        return (o, p) if want_probs else o


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer: x + SA(LN1 x), then x + FFN(LN2 x), with the
    torch-default LN eps 1e-5 and a ReLU FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, 1e-5)
        self.norm2 = LayerNorm(d_model, 1e-5)

    def forward(self, x, key_padding_mask: Optional[torch.Tensor] = None,
                want_probs: bool = False):
        """-> x, or (x, attention probs) with `want_probs`."""
        a = self.self_attn(self.norm1(x), key_padding_mask, want_probs)
        a, probs = a if want_probs else (a, None)
        x = x + a
        x = x + self.linear2(torch.relu(self.linear1(self.norm2(x))))
        return (x, probs) if want_probs else x
