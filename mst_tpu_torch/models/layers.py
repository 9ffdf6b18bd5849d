"""Transformer building blocks as parameter-holding `nn.Module`s.

Counterpart of `mst_tpu/models/layers.py`. Parameter names are the flax
ones, so `models/convert.params_from_flax` maps `a/b/c` to the attribute
path `a.b.c`: `patch_embed/proj/{kernel,bias}`, `blocks_i/{norm1,attn/qkv,
attn/proj,ls1,norm2,mlp/fc1,mlp/fc2,ls2}`, `norm`.

Matrices keep the flax Dense layout `kernel [in, out]`, which is also the
row-major `[K, N]` layout the CUDA kernels read. Parameters stay in f32, as
the JAX package keeps them; the forward functions cast matrices to the
compute dtype per call, as `vit_fast` does (the train sub-layers take the
f32 matrices and cast inside, so that their grads leave in f32).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mst_tpu_torch.ops.fused_block import (
    _ln,
    fused_attention_sublayer,
    fused_attention_sublayer_train,
    fused_mlp_sublayer,
    fused_mlp_sublayer_train,
)


class Dense(nn.Module):
    """flax `nn.Dense`: kernel [in, out], bias [out]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` (scale, bias): statistics in f32, output cast to
    the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _ln(x, self.scale, self.bias, self.eps).to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))


class _PatchProj(nn.Module):
    """Dense projection whose kernel is stored in conv HWIO shape
    [p, p, C, E]."""

    def __init__(self, patch_size: int, in_ch: int, embed_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(patch_size, patch_size, in_ch, embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))


class PatchEmbed(nn.Module):
    """Patchify NHWC -> [B, gh*gw, E] as a contraction over (p, p, C)."""

    def __init__(self, patch_size: int, embed_dim: int, in_ch: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = _PatchProj(patch_size, in_ch, embed_dim)

    def forward(self, x, dtype):
        n, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input size {(h, w)} not divisible by patch "
                             f"size {p}")
        gh, gw = h // p, w // p
        e = self.proj.kernel.shape[-1]
        xp = x.to(dtype).reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        kernel = self.proj.kernel.to(dtype).reshape(p * p * c, e)
        tokens = xp.reshape(n * gh * gw, p * p * c) @ kernel
        return tokens.reshape(n, gh * gw, e) + self.proj.bias.to(dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)


class Block(nn.Module):
    """Pre-norm ViT block with optional LayerScale; the forward runs the two
    fused sub-layers (hand-written kernels on CUDA): the serving ones, or
    with `train=True` the residual-saving ones whose backward is a kernel
    chain too (`vit_fast.fused_vit_cls(train=True)`)."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden: int,
                 layerscale_init: Optional[float] = 1e-5,
                 norm_eps: float = 1e-6, gelu_approximate: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.gelu_approximate = gelu_approximate
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = Mlp(dim, mlp_hidden)
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init)
            self.ls2 = LayerScale(dim, layerscale_init)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, h, train: bool = False):
        dt = h.dtype
        # the serving sub-layers take compute-dtype matrices, the train ones
        # the f32 parameters
        cast = (lambda w: w) if train else (lambda w: w.to(dt))
        attn = fused_attention_sublayer_train if train else \
            fused_attention_sublayer
        mlp = fused_mlp_sublayer_train if train else fused_mlp_sublayer
        h = attn(h, self.norm1.scale, self.norm1.bias,
                 cast(self.attn.qkv.kernel), self.attn.qkv.bias,
                 cast(self.attn.proj.kernel), self.attn.proj.bias,
                 None if self.ls1 is None else self.ls1.gamma,
                 self.num_heads, self.norm_eps)
        return mlp(h, self.norm2.scale, self.norm2.bias,
                   cast(self.mlp.fc1.kernel), self.mlp.fc1.bias,
                   cast(self.mlp.fc2.kernel), self.mlp.fc2.bias,
                   None if self.ls2 is None else self.ls2.gamma,
                   self.gelu_approximate, self.norm_eps)
