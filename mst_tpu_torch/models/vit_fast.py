"""Fused-kernel ViT / MST forward, for serving and for training.

Counterpart of `mst_tpu/models/vit_fast.py` (plain mode and `train=True`,
DINOv2 and DINOv3: the latter's 2D RoPE tables are built once per forward
and handed to every block; the MLP or SwiGLU FFN):
each encoder block but the last runs through the fused sub-layers
(`ops/fused_block.py`, hand-written CUDA kernels on the card; with
`train=True` the residual-saving ones, whose backward is a kernel chain
too), the last block is evaluated for the CLS token only
(`_cls_last_block`, plain ops as in the JAX package, differentiated by
autograd when training), and the slice fusion and head stay plain PyTorch.

The explainability forward (`fused_mst_saliency`) runs the same blocks
with one more output of the attention kernel: the last block's CLS row,
the rollout carry, or each block's Abnar factor.

A frozen encoder (`model.freeze`, the reference's giant2 workflow) trains
as the JAX package does: the encoder runs on the serving sub-layers under
`torch.no_grad()` and the backward stops at the slice fusion. With
`model.remat` each train block runs under `torch.utils.checkpoint` (JAX's
`jax.checkpoint` of `_fused_train_block`): only the block inputs stay
alive, and the backward runs each block's forward again to rebuild its
residuals.

An int8-quantized model (`ops/fused_int8.quantize_mst_int8`) runs the same
forward: each quantized block dispatches to the W8A8 sub-layers, and its
last block, left unquantized, is the CLS-only plain block.

Slices above `FUSED_MAX_TOKENS` tokens (518 px ViT-S/14: 1370) take the
composed path instead, the counterpart of flax `model.apply`:
`DinoSliceClassifier.forward` runs every encoder block in full on plain
products and `ops/attention.flash_attention` (the hand-written flash
kernels), then the slice fusion and head that `fusion_head` shares with
the fused path. `mst_logits` routes by the slice size alone, as the JAX
callers do (`mst_tpu/train/predictor.py:238-257`, `trainer.py:237-266`,
:365-385), and so does `fused_mst_saliency`: above FUSED_MAX_TOKENS its
`composed_mst_saliency` runs every block in full with the saliency output
of its plane mode (`ops/attention.flash_attention_saliency`: the CLS row,
the rollout carry or the Abnar factor, rebuilt by hand-written kernels
from `flash_fwd`'s LSE; JAX sows every block's [N, H, S, S]
probabilities there).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mst_tpu_torch.models.layers import QDense
from mst_tpu_torch.models.vit import _VIT_CONFIGS, interpolate_pos_embed
from mst_tpu_torch.ops.fused_block import _f, _ln
from mst_tpu_torch.ops.rotary import apply_rope_tables, rope_tables
from mst_tpu_torch.ops.saliency import (
    attention_rollout_from_factors,
    attention_rollout_from_row,
    combined_saliency,
    plane_attention_from_row,
    slice_attention,
    upsample_saliency,
)

# The fused sub-layers hold a slice's whole sequence per attention block
# (`mhsa` keeps K, V and the score rows in shared memory). Longer sequences
# take the composed path (`mst_logits`).
FUSED_MAX_TOKENS = 512


def fused_config_supported(model) -> bool:
    """Whether `model` runs on the fused path: it is the port's
    `DinoSliceClassifier`, in every slice fusion (JAX sends the rotary and
    non-transformer fusions through its flax composition, which computes
    the same function; here only the plain fusion differs). The ResNets
    run their own forward. There is no `embed_dim % 128` clause: that was
    a Mosaic lane limit, and the port's CPU path takes any width (its CUDA
    kernels check their own shape limits)."""
    return type(model).__name__ == "DinoSliceClassifier"


def int8_config_supported(model) -> bool:
    """Whether int8-quantized parameters of `model` may run: JAX's fused
    gate (`mst_tpu/models/vit_fast.py:48-71`), a DinoSliceClassifier with
    the transformer fusion and no rotary. JAX refuses int8 params in every
    other configuration with a ValueError (`mst_tpu/train/predictor.py
    :103-107, :248-255`, `trainer.py:227-236`), and so does the port."""
    return (fused_config_supported(model)
            and model.slice_fusion == "transformer" and model.rotary is None)


def check_int8_config(model) -> None:
    """JAX's ValueError for int8 params outside `int8_config_supported`."""
    if not int8_config_supported(model):
        raise ValueError(
            "int8-quantized params need the fused serving path; this "
            "config (rotary or non-transformer slice fusion, or a ResNet) "
            "falls back to the flax composition in mst_tpu, which has no "
            "int8 path")


def fused_seq_len_ok(model, height: int, width: int) -> bool:
    """Whether slices of this size fit the whole-sequence fused kernels
    (S = 1 + registers + patches <= FUSED_MAX_TOKENS)."""
    p = model.patch_size
    tokens = 1 + model.num_register_tokens + (height // p) * (width // p)
    return tokens <= FUSED_MAX_TOKENS


@dataclass(frozen=True)
class FastViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    num_register_tokens: int = 0
    pos_embed_grid: int = 37
    gelu_approximate: bool = True
    norm_eps: float = 1e-6
    use_pos_embed: bool = True  # False: DINOv3, positions from RoPE only
    use_rope_2d: bool = False
    rope_theta: float = 100.0
    rope_normalized: bool = False
    ffn_layer: str = "mlp"  # "mlp" | "swiglu" (giant2)

    @classmethod
    def from_model(cls, model) -> "FastViTConfig":
        base = _VIT_CONFIGS[model.model_size]
        enc = model.encoder
        return cls(
            embed_dim=base["embed_dim"], depth=base["depth"],
            num_heads=base["num_heads"], patch_size=model.patch_size,
            num_register_tokens=model.num_register_tokens,
            pos_embed_grid=model.pos_embed_grid,
            gelu_approximate=model.gelu_approximate,
            norm_eps=model.norm_eps,
            use_pos_embed=hasattr(enc, "pos_embed"),
            use_rope_2d=enc.use_rope_2d, rope_theta=enc.rope_theta,
            rope_normalized=enc.rope_normalized,
            ffn_layer=model.ffn_layer,
        )


def prepare_vit_tokens(enc, x, cfg: FastViTConfig, dtype=torch.bfloat16):
    """Patch embed (a (p, p, C) contraction against the HWIO kernel),
    bicubic pos-embed resampling (or none: DINOv3), CLS (+ register)
    prepend, and the 2D RoPE tables. x [N, H, W, 3] -> (h [N, S, E] in
    `dtype`, rope_cos, rope_sin: [S, head_dim] f32 on x's device, or None
    without RoPE)."""
    n, h, w, _ = x.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    e = cfg.embed_dim
    tokens = enc.patch_embed(x, dtype)
    cls = enc.cls_token.to(dtype)
    if cfg.use_pos_embed:
        pe = interpolate_pos_embed(
            enc.pos_embed, (gh, gw), (cfg.pos_embed_grid, cfg.pos_embed_grid)
        ).to(dtype)
        tokens = tokens + pe[:, 1:]
        cls = cls + pe[:, :1]
    parts = [cls.expand(n, 1, e)]
    if cfg.num_register_tokens:
        parts.append(enc.register_tokens.to(dtype).expand(
            n, cfg.num_register_tokens, e))
    parts.append(tokens)
    rope_cos = rope_sin = None
    if cfg.use_rope_2d:
        rope_cos, rope_sin = rope_tables(
            (gh, gw), e // cfg.num_heads, 1 + cfg.num_register_tokens,
            cfg.rope_theta, cfg.rope_normalized, x.device)
    return torch.cat(parts, dim=1), rope_cos, rope_sin


def _cls_last_block(h, blk, cfg: FastViTConfig, rope_cos=None,
                    rope_sin=None):
    """The final encoder block for the CLS token only (LN + k/v over all
    tokens, the q row / attention / proj / MLP for CLS alone), in plain ops
    as in the JAX package; with the RoPE tables the CLS q (row 0, the
    identity, applied anyway) and every k are rotated. Returns (cls_out
    [N, E] before the final norm, row [N, heads, S] f32: the per-head CLS
    softmax row)."""
    n, s, e = h.shape
    nh = cfg.num_heads
    hd = e // nh
    dt = h.dtype
    hn = _ln(h, blk.norm1.scale, blk.norm1.bias, cfg.norm_eps).to(dt)
    wqkv = blk.attn.qkv.kernel.to(dt)
    bqkv = blk.attn.qkv.bias.to(dt)
    q = hn[:, 0] @ wqkv[:, :e] + bqkv[:e]  # [N, E]: CLS query only
    kv = hn @ wqkv[:, e:] + bqkv[e:]  # [N, S, 2E]
    q = q.reshape(n, nh, hd)
    kv = kv.reshape(n, s, 2, nh, hd)
    k = kv[:, :, 0].transpose(1, 2)  # [N, nh, S, hd]
    v = kv[:, :, 1].transpose(1, 2)
    if rope_cos is not None:
        q = apply_rope_tables(q, rope_cos[0], rope_sin[0])
        k = apply_rope_tables(k, rope_cos, rope_sin)
    sc = torch.einsum("nhd,nhkd->nhk", _f(q), _f(k)) / math.sqrt(hd)
    row = torch.softmax(sc, dim=-1)  # [N, nh, S] f32
    o = torch.einsum("nhk,nhkd->nhd", _f(row.to(dt)), _f(v)).to(dt)
    y = o.reshape(n, e) @ blk.attn.proj.kernel.to(dt) + blk.attn.proj.bias.to(dt)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(dt)
    c = h[:, 0] + y  # [N, E]
    cn = _ln(c, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps).to(dt)
    if cfg.ffn_layer == "swiglu":
        h12 = cn @ blk.mlp.w12.kernel.to(dt) + blk.mlp.w12.bias.to(dt)
        h1, h2 = h12.chunk(2, dim=-1)
        m = (torch.nn.functional.silu(h1) * h2) @ blk.mlp.w3.kernel.to(dt) \
            + blk.mlp.w3.bias.to(dt)
    else:
        m = cn @ blk.mlp.fc1.kernel.to(dt) + blk.mlp.fc1.bias.to(dt)
        m = torch.nn.functional.gelu(
            m, approximate="tanh" if cfg.gelu_approximate else "none")
        m = m @ blk.mlp.fc2.kernel.to(dt) + blk.mlp.fc2.bias.to(dt)
    if blk.ls2 is not None:
        m = m * blk.ls2.gamma.to(dt)
    return c + m, row


def _fused_train_block(h, blk, rope_cos=None, rope_sin=None):
    """One encoder block on the residual-saving train sub-layers, a function
    of its input: the unit `remat` checkpoints (`mst_tpu`'s
    `_fused_train_block`)."""
    return blk(h, train=True, rope_cos=rope_cos, rope_sin=rope_sin)


def fused_vit_cls(enc, x, cfg: FastViTConfig, dtype=torch.bfloat16,
                  train: bool = False, want_last_row: bool = False,
                  want_rollout: bool = False, want_abnar: bool = False,
                  remat: bool = False):
    """enc: the VisionTransformer module; x [N, H, W, 3] -> CLS [N, E].
    `train=True` runs the blocks on the residual-saving sub-layers; with
    `remat` each under `torch.utils.checkpoint`, so that the backward
    recomputes the block's residuals from its input.

    The saliency modes (serving only, one at a time) return (cls, data):
    `want_last_row` the last block's per-head CLS softmax row [N, heads, S]
    f32; `want_rollout` the reference `get_attention_cls` chain's CLS row,
    a carry [N, heads, S] f32 moved through every block's attention kernel;
    `want_abnar` the list of every block's Abnar factor [N, S, S] f32 (the
    newest-first product cannot ride a forward carry)."""
    if sum((want_last_row, want_rollout, want_abnar)) > 1:
        raise ValueError("want_last_row / want_rollout / want_abnar are "
                         "mutually exclusive saliency modes")
    if train and (want_last_row or want_rollout or want_abnar):
        raise ValueError("the saliency modes are serving-only paths")
    h, rope_cos, rope_sin = prepare_vit_tokens(enc, x, cfg, dtype)
    rope = dict(rope_cos=rope_cos, rope_sin=rope_sin)
    carry = last_row = None
    factors = []
    if want_rollout:  # e_0: the chain starts empty
        carry = torch.zeros(h.shape[0], cfg.num_heads, h.shape[1],
                            device=h.device)
        carry[:, :, 0] = 1.0
    # The last block for the CLS token only, unless a mode needs its whole
    # attention or it is int8-quantized (`quantize_last=True`);
    # MST_NO_CHEAP_LAST (as in the JAX package) runs it in full, so "last"
    # takes its row from the `with_row` kernel.
    cheap_last = (not want_rollout and not want_abnar
                  and not isinstance(enc.block(cfg.depth - 1).attn.qkv, QDense)
                  and not os.environ.get("MST_NO_CHEAP_LAST"))
    for i in range(cfg.depth - 1 if cheap_last else cfg.depth):
        blk = enc.block(i)
        if want_rollout:
            h, carry = blk(h, carry=carry, **rope)
        elif want_abnar:
            h, amat = blk(h, abnar=True, **rope)
            factors.append(amat)
        elif want_last_row and i == cfg.depth - 1:
            h, last_row = blk(h, want_row=True, **rope)
        elif train and remat:
            h = checkpoint(_fused_train_block, h, blk, rope_cos, rope_sin,
                           use_reentrant=False)
        else:
            h = blk(h, train=train, **rope)
    if cheap_last:
        cls_vec, row = _cls_last_block(h, enc.block(cfg.depth - 1), cfg,
                                       **rope)
        if want_last_row:
            last_row = row
    else:
        cls_vec = h[:, 0]  # the final LN is per token
    cls = _ln(cls_vec, enc.norm.scale, enc.norm.bias, cfg.norm_eps).to(dtype)
    if want_rollout:
        return cls, carry
    if want_abnar:
        return cls, factors
    if want_last_row:
        return cls, last_row
    return cls


def _linear_resize_weights(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] matrix of `jax.image.resize(..., "linear")` along one axis
    when upsampling: half-pixel centres, triangle kernel, edge weights
    renormalised (which equals clamping the source coordinate)."""
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = (i + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1.0)
        i0 = int(np.floor(src))
        t = src - i0
        w[i, i0] += 1.0 - t
        if t > 0:
            w[i, i0 + 1] += t
    return w.astype(np.float32)


def fused_mst_logits(model, source, src_key_padding_mask=None, dtype=None,
                     train: bool = False, encoder=None):
    """Full MST forward on the fused path: source [B, C, D, H, W] ->
    logits [B, out_ch] f32. `model` is the port's DinoSliceClassifier (it
    holds the parameters); `dtype` defaults to `model.dtype`. `train=True`
    selects the residual-sharing train sub-layers (the loss backward runs
    their backward kernels; valid because the model has no dropout), each
    block checkpointed with `model.remat`; for a frozen model
    (`model.freeze`) the encoder runs on the serving sub-layers under
    `torch.no_grad()` instead. `dtype` float64 on the plain sub-layers is
    the oracle of the bf16 paths (the plain versions keep f64).
    `encoder` runs in place of `model.encoder` (a frozen model's int8 copy,
    `ops/fused_int8.quantize_frozen_encoder_int8`: JAX's
    `params["encoder"] = int8_encoder`, `mst_tpu/train/trainer.py:244-249`);
    with `train` it must be a frozen model's (an unfrozen one would train
    through the int8 blocks, which refuse it)."""
    _check_fused(model, source)
    dtype = model.dtype if dtype is None else dtype
    return _fused_mst(model, source, src_key_padding_mask, dtype, train,
                      encoder=encoder)[0]


PLANE_MODES = ("last", "rollout", "rollout_abnar")


def fused_mst_saliency(model, source, src_key_padding_mask=None, dtype=None,
                       plane_mode: str = "last"):
    """(probs [B, classes] f32, saliency [B, D, H, W] f32) on the fused
    serving path, without any [S, S] attention matrix of a head in device
    memory. plane_mode "last": the last block's CLS row;
    "rollout": the reference `get_attention_cls` chain's CLS row, carried
    through every block's kernel; "rollout_abnar": the Abnar & Zuidema
    rollout, on the fused path of the per-block factors the kernels emit,
    chained in f32 by `torch.matmul`; on the composed path the CLS row of
    their product, carried back through the blocks (no factor is made).
    Slice weights come from the fusion layer's probs.
    Slices above FUSED_MAX_TOKENS take the composed saliency forward
    (`composed_mst_saliency`), as JAX takes its flax path there; an
    int8-quantized model raises JAX's ValueError there."""
    if plane_mode not in PLANE_MODES:
        raise ValueError(f"plane_mode {plane_mode!r} not in {PLANE_MODES}")
    _check_fused_config(model)
    long_slices = not fused_seq_len_ok(model, *source.shape[-2:])
    if has_int8(model):
        if long_slices:  # JAX's order: int8 params have no flax saliency
            raise ValueError(
                "int8-quantized params need the fused serving path; this "
                f"saliency input exceeds FUSED_MAX_TOKENS={FUSED_MAX_TOKENS}")
        check_int8_config(model)
    dtype = model.dtype if dtype is None else dtype
    b, d, hh, ww = source.shape[0], *source.shape[2:]
    p = model.patch_size
    forward = composed_mst_saliency if long_slices else _fused_mst
    logits, sal_data, fusion_probs = forward(
        model, source, src_key_padding_mask, dtype, plane_mode=plane_mode)
    probs = torch.softmax(logits.float(), -1)
    if fusion_probs is None:  # average / linear fusion: uniform weights
        sw = torch.full((b, d), 1.0 / d, device=probs.device)
    else:
        sw = slice_attention(fusion_probs)
    n_prefix = 1 + model.num_register_tokens
    gh, gw = hh // p, ww // p
    if plane_mode == "rollout_abnar":
        rollout = (attention_rollout_from_row if long_slices
                   else attention_rollout_from_factors)
        pw = rollout(sal_data, n_prefix).reshape(-1, gh, gw)
    else:
        pw = plane_attention_from_row(sal_data, n_prefix, (gh, gw))
    return probs, upsample_saliency(combined_saliency(sw, pw), (d, hh, ww))


def composed_mst_saliency(model, source, src_key_padding_mask, dtype,
                          plane_mode: str):
    """The composed path's saliency forward (slices above
    FUSED_MAX_TOKENS; flax `model.apply(return_weights=...)` in JAX):
    `VisionTransformer.forward_saliency` over the tokens of
    `prepare_vit_tokens`, every block in full on plain products and the
    flash kernels, each block's attention with the saliency output of
    `plane_mode`; then the fusion and head of `fusion_head` with its
    probabilities -> (logits, saliency data, fusion probs), as
    `_fused_mst` returns them."""
    b, d = source.shape[0], source.shape[2]
    h, rope_cos, rope_sin = prepare_vit_tokens(
        model.encoder, slices_nhwc(source), FastViTConfig.from_model(model),
        dtype)
    feats, sal_data = model.encoder.forward_saliency(h, rope_cos, rope_sin,
                                                     plane_mode)
    logits, fusion_probs = fusion_head(model, feats, b, d,
                                       src_key_padding_mask, dtype,
                                       want_probs=True)
    return logits, sal_data, fusion_probs


def _check_fused_config(model):
    if not fused_config_supported(model):
        raise NotImplementedError(
            f"{type(model).__name__} config is outside the fused serving path")


def _check_fused(model, source):
    _check_fused_config(model)
    if not fused_seq_len_ok(model, *source.shape[-2:]):
        raise NotImplementedError(
            f"{tuple(source.shape[-2:])} slices exceed FUSED_MAX_TOKENS="
            f"{FUSED_MAX_TOKENS} tokens: they take the composed path "
            f"(`mst_logits`, `DinoSliceClassifier.forward`)")


def has_int8(model) -> bool:
    """Whether `model`'s encoder holds W8A8 blocks (`QDense` products)."""
    enc = model.encoder
    return any(isinstance(enc.block(i).attn.qkv, QDense)
               for i in range(enc.depth))


def mst_logits(model, source, src_key_padding_mask=None, train: bool = False,
               dtype=None, encoder=None):
    """logits [B, out_ch] f32 of `model` in `dtype` (default
    `model.dtype`), routed as the JAX callers route (`fused_seq_len_ok`
    alone): the fused path (`fused_mst_logits`) where the slices fit
    FUSED_MAX_TOKENS, else the composed path (`DinoSliceClassifier.forward`,
    flax `model.apply`). An int8-quantized model has no composed path:
    ValueError, as JAX raises for int8 params there
    (`mst_tpu/train/predictor.py:248-255`); so has an int8 `encoder`
    (`fused_mst_logits`), and int8 params in a configuration outside
    `int8_config_supported`. A model outside the fused path (the ResNets)
    runs its own forward, `train` selecting batch statistics."""
    fused = fused_config_supported(model)
    if encoder is not None or (fused and has_int8(model)):
        check_int8_config(model)
    if not fused:
        return model(source, src_key_padding_mask, train=train, dtype=dtype)
    if fused_seq_len_ok(model, *source.shape[-2:]):
        return fused_mst_logits(model, source, src_key_padding_mask, dtype,
                                train, encoder)
    if has_int8(model) or encoder is not None:
        raise ValueError(
            "int8-quantized params need the fused serving path; this input "
            "falls back to the composed path (slice tokens must be <= "
            f"vit_fast.FUSED_MAX_TOKENS = {FUSED_MAX_TOKENS}, got "
            f"{tuple(source.shape[-2:])} slices)")
    return model(source, src_key_padding_mask, train=train, dtype=dtype)


def slices_nhwc(source):
    """[B, C, D, H, W] -> the slice batch [B*D, H, W, 3] (gray -> RGB, a
    broadcast view)."""
    b, c, d, hh, ww = source.shape
    x = source.permute(0, 2, 3, 4, 1).reshape(b * d, hh, ww, c)
    return x.expand(b * d, hh, ww, 3) if c == 1 else x


def _fused_mst(model, source, src_key_padding_mask, dtype, train=False,
               plane_mode=None, encoder=None):
    """-> (logits, saliency data | None, fusion probs | None); with a
    `plane_mode` the encoder runs that saliency mode and the last fusion
    layer returns its probabilities [B, heads, 1+D, 1+D] f32. `encoder`
    (default `model.encoder`) is the encoder that runs."""
    if train:
        model.check_trainable(source.device)
    enc = model.encoder if encoder is None else encoder
    cfg = FastViTConfig.from_model(model)
    b, d = source.shape[0], source.shape[2]
    x = slices_nhwc(source)
    sal_data = None
    if plane_mode is None and train and model.freeze:
        # mst_tpu/models/vit_fast.py:577-584: the encoder on the serving
        # kernels (no residuals to save), no grad past its output
        with torch.no_grad():
            feats = fused_vit_cls(enc, x, cfg, dtype)
    elif plane_mode is None:
        feats = fused_vit_cls(enc, x, cfg, dtype, train,
                              remat=train and model.remat)
    else:
        feats, sal_data = fused_vit_cls(
            enc, x, cfg, dtype, want_last_row=plane_mode == "last",
            want_rollout=plane_mode == "rollout",
            want_abnar=plane_mode == "rollout_abnar")
    logits, fusion_probs = fusion_head(model, feats, b, d,
                                       src_key_padding_mask, dtype,
                                       want_probs=plane_mode is not None)
    return logits, sal_data, fusion_probs


def fusion_head(model, feats, b: int, d: int, src_key_padding_mask, dtype,
                want_probs: bool = False):
    """The slice fusion and head of both paths (mst_tpu/models/mst.py
    :176-228): the per-slice CLS features [B*D, E] -> [bottleneck], slice
    position table, then by `model.slice_fusion`: `transformer` the volume
    CLS token, the fusion layers (with their rotary) under the key-padding
    mask [B, D] (True = pad), the fusion norm and the CLS row; `average`
    the mean over the slices the mask leaves (at least one counted);
    `linear` / `none` the flat [B, D * e] features; then the head in f32
    -> (logits [B, out_ch] f32, the last fusion layer's probabilities [B,
    heads, 1+D, 1+D] f32 with `want_probs` and a transformer fusion, else
    None)."""
    fusion_probs = None
    if model.use_bottleneck:
        feats = model.bottleneck(feats)
    e = feats.shape[-1]
    feats = feats.reshape(b, d, e)
    if model.use_slice_pos_emb:
        table = model.slice_pos_emb.embedding
        if d <= table.shape[0]:
            pos = table[:d]
        else:
            # Past the 256-entry vocabulary: depth-interpolate the table
            # like the flax path (models/mst.py) instead of clamping.
            wl = torch.from_numpy(
                _linear_resize_weights(d, table.shape[0])).to(table.device)
            pos = wl @ table.float()
        feats = feats + pos[None].to(dtype)

    mask = None
    if src_key_padding_mask is not None:
        mask = torch.as_tensor(src_key_padding_mask, dtype=torch.bool,
                               device=feats.device)
    if model.slice_fusion == "average":
        if mask is None:
            pooled = _f(feats).mean(1).to(dtype)
        else:
            valid = (~mask)[..., None].to(_f(feats).dtype)
            pooled = ((_f(feats) * valid).sum(1) / valid.sum(1).clamp_min(
                1.0)).to(dtype)
    elif model.slice_fusion in ("linear", "none"):
        if d != model.num_slices:
            raise ValueError(f"a {model.slice_fusion} slice fusion head "
                             f"takes {model.num_slices} slices, got {d}")
        pooled = feats.reshape(b, d * e)
    else:
        h = torch.cat([model.cls_token.to(dtype).expand(b, 1, e), feats],
                      dim=1)
        pad = None
        if mask is not None:
            # the CLS column is never padded (reference `dino.py:147-150`)
            pad = torch.cat([torch.zeros_like(mask[:, :1]), mask], dim=1)
        for i in range(model.fusion_layers):
            if want_probs and i == model.fusion_layers - 1:
                h, fusion_probs = model.fusion(i)(h, pad, want_probs=True)
            else:
                h = model.fusion(i)(h, pad)
        pooled = model.fusion_norm(h)[:, 0]
    pooled = _f(pooled)
    logits = (pooled @ model.head.kernel.to(pooled.dtype)
              + model.head.bias.to(pooled.dtype))
    return logits, fusion_probs

