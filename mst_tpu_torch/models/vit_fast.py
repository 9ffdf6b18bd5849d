"""Fused-kernel ViT / MST forward, for serving and for training.

Counterpart of `mst_tpu/models/vit_fast.py` (plain mode and `train=True`):
each encoder block but the last runs through the fused sub-layers
(`ops/fused_block.py`, hand-written CUDA kernels on the card; with
`train=True` the residual-saving ones, whose backward is a kernel chain
too), the last block is evaluated for the CLS token only
(`_cls_last_block`, plain ops as in the JAX package, differentiated by
autograd when training), and the slice fusion and head stay plain PyTorch.

This is the port's only forward: configurations outside the gate raise
instead of running a second composition. Saliency, `remat`, frozen-encoder
training, int8 and the long-sequence flash path are later ROADMAP items.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from mst_tpu_torch.models.vit import _VIT_CONFIGS, interpolate_pos_embed
from mst_tpu_torch.ops.fused_block import _ln

# The fused sub-layers hold a slice's whole sequence per attention block
# (`mhsa` keeps K, V and the score rows in shared memory). Longer sequences
# need the flash-attention path, ROADMAP queue A #10.
FUSED_MAX_TOKENS = 512


def fused_config_supported(model) -> bool:
    """Whether `model` runs on the fused path: it is the port's
    `DinoSliceClassifier`, whose constructor refuses every configuration
    outside the path (rotary or non-transformer fusion, DINOv3, SwiGLU), so
    the model conditions of the JAX gate live there. There is no
    `embed_dim % 128` clause: that was a Mosaic lane limit, and the port's
    CPU path takes any width (its CUDA kernels check their own shape
    limits)."""
    return type(model).__name__ == "DinoSliceClassifier"


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

    @classmethod
    def from_model(cls, model) -> "FastViTConfig":
        base = _VIT_CONFIGS[model.model_size]
        return cls(
            embed_dim=base["embed_dim"], depth=base["depth"],
            num_heads=base["num_heads"], patch_size=model.patch_size,
            num_register_tokens=model.num_register_tokens,
            pos_embed_grid=model.pos_embed_grid,
            gelu_approximate=model.gelu_approximate,
            norm_eps=model.norm_eps,
        )


def prepare_vit_tokens(enc, x, cfg: FastViTConfig, dtype=torch.bfloat16):
    """Patch embed (a (p, p, C) contraction against the HWIO kernel),
    bicubic pos-embed resampling, CLS (+ register) prepend.
    x [N, H, W, 3] -> h [N, S, E] in `dtype`."""
    n, h, w, _ = x.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    e = cfg.embed_dim
    tokens = enc.patch_embed(x, dtype)
    pe = interpolate_pos_embed(
        enc.pos_embed, (gh, gw), (cfg.pos_embed_grid, cfg.pos_embed_grid)
    ).to(dtype)
    tokens = tokens + pe[:, 1:]
    parts = [(enc.cls_token.to(dtype) + pe[:, :1]).expand(n, 1, e)]
    if cfg.num_register_tokens:
        parts.append(enc.register_tokens.to(dtype).expand(
            n, cfg.num_register_tokens, e))
    parts.append(tokens)
    return torch.cat(parts, dim=1)


def _cls_last_block(h, blk, cfg: FastViTConfig):
    """The final encoder block for the CLS token only (LN + k/v over all
    tokens, the q row / attention / proj / MLP for CLS alone), in plain ops
    as in the JAX package. Returns (cls_out [N, E] before the final norm,
    row [N, heads, S] f32: the per-head CLS softmax row)."""
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
    sc = torch.einsum("nhd,nhkd->nhk", q.float(), k.float()) / math.sqrt(hd)
    row = torch.softmax(sc, dim=-1)  # [N, nh, S] f32
    o = torch.einsum("nhk,nhkd->nhd", row.to(dt).float(), v.float()).to(dt)
    y = o.reshape(n, e) @ blk.attn.proj.kernel.to(dt) + blk.attn.proj.bias.to(dt)
    if blk.ls1 is not None:
        y = y * blk.ls1.gamma.to(dt)
    c = h[:, 0] + y  # [N, E]
    cn = _ln(c, blk.norm2.scale, blk.norm2.bias, cfg.norm_eps).to(dt)
    m = cn @ blk.mlp.fc1.kernel.to(dt) + blk.mlp.fc1.bias.to(dt)
    m = torch.nn.functional.gelu(
        m, approximate="tanh" if cfg.gelu_approximate else "none")
    m = m @ blk.mlp.fc2.kernel.to(dt) + blk.mlp.fc2.bias.to(dt)
    if blk.ls2 is not None:
        m = m * blk.ls2.gamma.to(dt)
    return c + m, row


def fused_vit_cls(enc, x, cfg: FastViTConfig, dtype=torch.bfloat16,
                  train: bool = False):
    """enc: the VisionTransformer module; x [N, H, W, 3] -> CLS [N, E].
    `train=True` runs the blocks on the residual-saving sub-layers."""
    h = prepare_vit_tokens(enc, x, cfg, dtype)
    for i in range(cfg.depth - 1):
        h = enc.block(i)(h, train=train)
    cls_vec, _ = _cls_last_block(h, enc.block(cfg.depth - 1), cfg)
    hf = _ln(cls_vec, enc.norm.scale, enc.norm.bias, cfg.norm_eps)
    return hf.to(dtype)


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
                     train: bool = False):
    """Full MST forward on the fused path: source [B, C, D, H, W] ->
    logits [B, out_ch] f32. `model` is the port's DinoSliceClassifier (it
    holds the parameters); `dtype` defaults to `model.dtype`. `train=True`
    selects the residual-sharing train sub-layers (the loss backward runs
    their backward kernels; valid because the model has no dropout)."""
    if not fused_config_supported(model):
        raise NotImplementedError(
            f"{type(model).__name__} config is outside the fused serving path")
    if not fused_seq_len_ok(model, *source.shape[-2:]):
        raise NotImplementedError(
            f"{tuple(source.shape[-2:])} slices exceed FUSED_MAX_TOKENS="
            f"{FUSED_MAX_TOKENS} tokens; the flash-attention path is ROADMAP "
            f"queue A #10")
    dtype = model.dtype if dtype is None else dtype
    return _fused_mst(model, source, src_key_padding_mask, dtype, train)


def _fused_mst(model, source, src_key_padding_mask, dtype, train=False):
    cfg = FastViTConfig.from_model(model)
    b, c, d, hh, ww = source.shape
    x = source.permute(0, 2, 3, 4, 1).reshape(b * d, hh, ww, c)
    if c == 1:
        x = x.expand(b * d, hh, ww, 3)  # gray -> RGB
    feats = fused_vit_cls(model.encoder, x, cfg, dtype, train)
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

    h = torch.cat([model.cls_token.to(dtype).expand(b, 1, e), feats], dim=1)
    pad = None
    if src_key_padding_mask is not None:
        # the CLS column is never padded (reference `dino.py:147-150`)
        m = torch.as_tensor(src_key_padding_mask, dtype=torch.bool,
                            device=h.device)
        pad = torch.cat([torch.zeros_like(m[:, :1]), m], dim=1)
    for i in range(model.fusion_layers):
        h = model.fusion(i)(h, pad)
    h = model.fusion_norm(h)
    pooled = h[:, 0].float()
    return pooled @ model.head.kernel.float() + model.head.bias.float()

