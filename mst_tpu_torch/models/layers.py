"""Transformer building blocks as parameter-holding `nn.Module`s.

Counterpart of `mst_tpu/models/layers.py`. `Block.forward` runs the fused
sub-layers (the path of slices up to `vit_fast.FUSED_MAX_TOKENS`);
`Block.forward_composed` is the flax `Block.__call__` composition, for
longer slices: LN, the qkv product, [RoPE], `flash_attention` (the
hand-written flash kernels on CUDA), the proj product, LayerScale and the
residual, then LN, the MLP or SwiGLU, LayerScale and the residual; with a
saliency switch its attention is `flash_attention_saliency` (the flash
forward with its LSE, then the CLS-row, carry or Abnar kernel). Its
products stay `torch.matmul`, as the JAX package leaves them to XLA.

Parameter names are the flax ones, so `models/convert.params_from_flax`
maps `a/b/c` to the attribute path `a.b.c`: `patch_embed/proj/{kernel,bias}`, `blocks_i/{norm1,attn/qkv,
attn/proj,ls1,norm2,mlp/fc1,mlp/fc2,ls2}` (the SwiGLU FFN: `mlp/w12`,
`mlp/w3`), `norm`.

Matrices keep the flax Dense layout `kernel [in, out]`, which is also the
row-major `[K, N]` layout the CUDA kernels read. An int8-quantized model
(`ops/fused_int8.quantize_mst_int8`) holds `QDense` layers in place of its
blocks' token-wise `Dense` ones, with the flax node names `q8`, `scale`,
`bias`, `a_inv` as buffers. Parameters stay in f32, as
the JAX package keeps them; the forward functions cast matrices to the
compute dtype per call, as `vit_fast` does (the train sub-layers take the
f32 matrices and cast inside, so that their grads leave in f32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mst_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_saliency,
)
from mst_tpu_torch.ops.fused_block import (
    _ln,
    fused_attention_sublayer,
    fused_attention_sublayer_abnar,
    fused_attention_sublayer_rollout,
    fused_attention_sublayer_rope,
    fused_attention_sublayer_rope_with_row,
    fused_attention_sublayer_train,
    fused_attention_sublayer_train_rope,
    fused_attention_sublayer_with_row,
    fused_mlp_sublayer,
    fused_mlp_sublayer_train,
    fused_swiglu_sublayer,
    fused_swiglu_sublayer_train,
)
from mst_tpu_torch.ops.fused_int8 import (
    fused_attention_sublayer_i8,
    fused_mlp_sublayer_i8,
    fused_swiglu_sublayer_i8,
)
from mst_tpu_torch.ops.rotary import apply_rope_tables


class Dense(nn.Module):
    """flax `nn.Dense`: kernel [in, out], bias [out]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class QDense(nn.Module):
    """A Dense layer quantized for W8A8 serving (the JAX `{"q8", "scale",
    "bias"[, "a_inv"]}` node): `q8` int8 [in, out], `scale` f32 [1, out]
    per output channel, `bias` f32 [out], and on the second FFN product of
    a static tree `a_inv` f32 [1, 1] (the calibrated hidden scale; None
    for dynamic trees). Buffers, never cast: the int8 sub-layers read them
    as they are. Beside them `q8t` int8 [out, in], the K-major copy of q8
    that the int8 wgmma GEMM reads (it takes both operands K-major), made
    once here: a buffer outside the state dict, so the tree's leaves stay
    the JAX node's. It has no forward of its own."""

    def __init__(self, q8, scale, bias, a_inv=None):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("q8t", q8.t().contiguous(), persistent=False)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self.register_buffer("a_inv", a_inv)


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

    def forward(self, x, rope_cos=None, rope_sin=None, want_row=False,
                carry=None, abnar=False):
        """flax `Attention` without weights or bias: x [N, S, E] -> [N, S,
        E]. q, k, v are head views of the packed qkv (no copy); with the
        RoPE tables ([S, head_dim] f32) q and k are rotated first. With one
        saliency switch (serving only; `Block.forward`'s flags of the fused
        path) -> (y, the CLS row [N, heads, S] | the carry [N, heads, S]
        moved on | the block's Abnar state (q, k, LSE, row normaliser [N,
        S])), f32, where the flax path's `return_weights` sows the
        probabilities themselves: here `flash_fwd` keeps its LSE and a
        kernel rebuilds what the mode needs from it and the same q, k."""
        n, s, e = x.shape
        qkv = self.qkv(x).view(n, s, 3, self.num_heads, e // self.num_heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        if rope_cos is not None:
            q, k = (apply_rope_tables(t, rope_cos, rope_sin) for t in (q, k))
        extra = None
        if want_row or carry is not None or abnar:
            o, extra = flash_attention_saliency(q, k, v, want_row, carry,
                                                abnar)
        else:
            o = flash_attention(q, k, v)  # laid out [N, S, heads, head_dim]
        y = self.proj(o.transpose(1, 2).reshape(n, s, e))
        return y if extra is None else (y, extra)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x, approximate: bool = True):
        return self.fc2(F.gelu(self.fc1(x),
                               approximate="tanh" if approximate else "none"))


class SwiGLU(nn.Module):
    """flax `SwiGLU`: w12 [dim, 2 * hidden] (h1 then h2), w3 [hidden, dim];
    `hidden` is the gate width F after the rounding rule
    (`VisionTransformer` applies it)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = Dense(dim, 2 * hidden)
        self.w3 = Dense(hidden, dim)

    def forward(self, x):
        h1, h2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(h1) * h2)


class Block(nn.Module):
    """Pre-norm ViT block with optional LayerScale; the forward runs the two
    fused sub-layers (hand-written kernels on CUDA): the serving ones, or
    with `train=True` the residual-saving ones whose backward is a kernel
    chain too (`vit_fast.fused_vit_cls(train=True)`). With the RoPE tables
    (DINOv3) every attention variant takes its RoPE form, as
    `mst_tpu/models/vit_fast.py:429-450` dispatches. `ffn_layer="swiglu"`
    (giant2) runs the FFN through the SwiGLU sub-layer in every mode (with
    `train=True` the residual-saving one, queue B row 6). A block whose
    products are `QDense` (int8-quantized) serves through the int8
    sub-layers in every mode, as `mst_tpu/models/vit_fast.py:378-422`
    dispatches on "q8"; it refuses `train=True`."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden: int,
                 layerscale_init: Optional[float] = 1e-5,
                 norm_eps: float = 1e-6, gelu_approximate: bool = True,
                 ffn_layer: str = "mlp"):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.gelu_approximate = gelu_approximate
        self.ffn_layer = ffn_layer
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = (SwiGLU(dim, mlp_hidden) if ffn_layer == "swiglu"
                    else Mlp(dim, mlp_hidden))
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init)
            self.ls2 = LayerScale(dim, layerscale_init)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, h, train: bool = False, want_row: bool = False,
                carry=None, abnar: bool = False, rope_cos=None,
                rope_sin=None):
        """-> h. With `carry`, `abnar` or `want_row` (serving only) the
        attention sub-layer is its explainability variant and the block
        returns (h, new_carry | Abnar factor | CLS row). `rope_cos` /
        `rope_sin` ([S, head_dim] f32): RoPE on q and k."""
        if isinstance(self.attn.qkv, QDense):
            return self._forward_i8(h, train, want_row, carry, abnar,
                                    rope_cos, rope_sin)
        dt = h.dtype
        # the serving sub-layers take compute-dtype matrices, the train ones
        # the f32 parameters
        cast = (lambda w: w) if train else (lambda w: w.to(dt))
        attn_args = (h, self.norm1.scale, self.norm1.bias,
                     cast(self.attn.qkv.kernel), self.attn.qkv.bias,
                     cast(self.attn.proj.kernel), self.attn.proj.bias,
                     None if self.ls1 is None else self.ls1.gamma)
        rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
        tables = () if rope_cos is None else (rope_cos, rope_sin)
        extra = None
        if carry is not None:
            h, extra = fused_attention_sublayer_rollout(
                *attn_args, carry, self.num_heads, self.norm_eps, **rope)
        elif abnar:
            h, extra = fused_attention_sublayer_abnar(
                *attn_args, self.num_heads, self.norm_eps, **rope)
        elif want_row:
            row_fn = (fused_attention_sublayer_with_row if not tables else
                      fused_attention_sublayer_rope_with_row)
            h, extra = row_fn(*attn_args, *tables, self.num_heads,
                              self.norm_eps)
        else:
            if train:
                attn = (fused_attention_sublayer_train if not tables else
                        fused_attention_sublayer_train_rope)
            else:
                attn = (fused_attention_sublayer if not tables else
                        fused_attention_sublayer_rope)
            h = attn(*attn_args, *tables, self.num_heads, self.norm_eps)
        ls2 = None if self.ls2 is None else self.ls2.gamma
        ffn_in, ffn_out = ((self.mlp.w12, self.mlp.w3)
                           if self.ffn_layer == "swiglu"
                           else (self.mlp.fc1, self.mlp.fc2))
        ffn_args = (h, self.norm2.scale, self.norm2.bias, cast(ffn_in.kernel),
                    ffn_in.bias, cast(ffn_out.kernel), ffn_out.bias, ls2)
        if self.ffn_layer == "swiglu":
            ffn = fused_swiglu_sublayer_train if train else fused_swiglu_sublayer
            h = ffn(*ffn_args, self.norm_eps)
        else:
            ffn = fused_mlp_sublayer_train if train else fused_mlp_sublayer
            h = ffn(*ffn_args, self.gelu_approximate, self.norm_eps)
        return h if extra is None else (h, extra)

    def forward_composed(self, h, rope_cos=None, rope_sin=None,
                         want_row=False, carry=None, abnar=False):
        """The flax `Block.__call__` (mst_tpu/models/layers.py:177-219) on
        plain products and `flash_attention`: h [N, S, E] -> [N, S, E],
        differentiable by autograd (the attention through its kernels'
        backward). `rope_cos` / `rope_sin` ([S, head_dim] f32): RoPE on q
        and k. With `want_row`, `carry` or `abnar` (serving only, as
        `forward` takes them) -> (h, CLS row | new carry | Abnar state of
        `flash_attention_saliency`)."""
        y = self.attn(self.norm1(h), rope_cos, rope_sin, want_row, carry,
                      abnar)
        extra = None
        if isinstance(y, tuple):
            y, extra = y
        if self.ls1 is not None:
            y = y * self.ls1.gamma.to(y.dtype)
        h = h + y
        y = self.norm2(h)
        y = (self.mlp(y) if self.ffn_layer == "swiglu"
             else self.mlp(y, self.gelu_approximate))
        if self.ls2 is not None:
            y = y * self.ls2.gamma.to(y.dtype)
        return h + y if extra is None else (h + y, extra)

    def _forward_i8(self, h, train, want_row, carry, abnar, rope_cos,
                    rope_sin):
        """The int8 block: the W8A8 attention sub-layer (with the saliency
        output asked for), then the W8A8 MLP or SwiGLU; static when the
        second FFN product carries `a_inv`."""
        if train:
            raise ValueError("int8-quantized blocks serve only (training "
                             "rides the bf16 kernels)")
        ffn_in, ffn_out = ((self.mlp.w12, self.mlp.w3)
                           if self.ffn_layer == "swiglu"
                           else (self.mlp.fc1, self.mlp.fc2))
        out = fused_attention_sublayer_i8(
            h, self.norm1.scale, self.norm1.bias, self.attn.qkv,
            self.attn.proj, None if self.ls1 is None else self.ls1.gamma,
            self.num_heads, self.norm_eps, rope_cos=rope_cos,
            rope_sin=rope_sin, static=ffn_out.a_inv is not None,
            want_row=want_row, carry=carry, abnar=abnar)
        h, extra = out if isinstance(out, tuple) else (out, None)
        ls2 = None if self.ls2 is None else self.ls2.gamma
        if self.ffn_layer == "swiglu":
            h = fused_swiglu_sublayer_i8(h, self.norm2.scale, self.norm2.bias,
                                         ffn_in, ffn_out, ls2, self.norm_eps)
        else:
            h = fused_mlp_sublayer_i8(h, self.norm2.scale, self.norm2.bias,
                                      ffn_in, ffn_out, ls2,
                                      self.gelu_approximate, self.norm_eps)
        return h if extra is None else (h, extra)
