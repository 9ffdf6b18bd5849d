"""DINOv2 / DINOv3 Vision Transformer parameters and pos-embed resampling.

Counterpart of `mst_tpu/models/vit.py`: the size table, the bicubic
position-embedding interpolation (built from explicit numpy weight
matrices, so the reference's 0.1-offset scale factor stays exact), and the
encoder module holding the parameters under the flax names (the FFN an MLP
or, for giant2, a SwiGLU). Slices of up to `vit_fast.FUSED_MAX_TOKENS`
tokens run `models/vit_fast.fused_vit_cls`; longer ones the module's own
forward, the composed flax `VisionTransformer.__call__` over the tokens of
`vit_fast.prepare_vit_tokens`. DINOv3's positions come from the 2D RoPE
(`ops/rotary.py`), so its encoder has no `pos_embed`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mst_tpu_torch.models.layers import Block, LayerNorm, PatchEmbed
from mst_tpu_torch.ops.attention import abnar_rollout_row

_VIT_CONFIGS = {
    "tiny": dict(embed_dim=32, depth=2, num_heads=2),  # tests only
    "tiny128": dict(embed_dim=128, depth=2, num_heads=2),  # tests only
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "giant2": dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglu"),
}


def _cubic_weights(out_size: int, in_size: int, scale: float) -> np.ndarray:
    """Dense [out, in] interpolation matrix replicating torch's bicubic
    (`F.interpolate(mode='bicubic', align_corners=False, antialias=False)`,
    cubic convolution with a = -0.75, edge-clamped)."""
    a = -0.75

    def k(t):
        t = np.abs(t)
        return np.where(
            t <= 1,
            (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
        )

    w = np.zeros((out_size, in_size), np.float64)
    offs = np.array([-1, 0, 1, 2])
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        for o, wt in zip(offs, k(src - i0 - offs)):
            w[i, int(np.clip(i0 + o, 0, in_size - 1))] += wt
    return w.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw, src_grid,
                          interpolate_offset: float = 0.1) -> torch.Tensor:
    """Bicubic-resample patch position embeddings [1, 1 + sh*sw, dim] (CLS
    first) to the grid `grid_hw`, with the reference's
    `interpolate_offset=0.1` scale-factor kludge."""
    sh, sw = src_grid
    h, w = grid_hw
    if (h, w) == (sh, sw):
        return pos_embed
    if interpolate_offset:
        sy = float(h + interpolate_offset) / sh
        sx = float(w + interpolate_offset) / sw
    else:
        sy, sx = h / sh, w / sw
    dev = pos_embed.device
    wy = torch.from_numpy(_cubic_weights(h, sh, sy)).to(dev)
    wx = torch.from_numpy(_cubic_weights(w, sw, sx)).to(dev)
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    dim = patch_pe.shape[-1]
    grid = patch_pe.reshape(sh, sw, dim).float()
    grid = torch.einsum("hH,HWd,wW->hwd", wy, grid, wx)
    grid = grid.reshape(1, h * w, dim).to(pos_embed.dtype)
    return torch.cat([cls_pe, grid], dim=1)


class VisionTransformer(nn.Module):
    """ViT encoder parameters: patch_embed, cls_token, [pos_embed],
    [register_tokens], blocks_0..blocks_{depth-1}, norm. `use_pos_embed=False`
    (DINOv3) keeps no learned position embedding; `use_rope_2d`,
    `rope_theta` and `rope_normalized` set the 2D RoPE the forward builds.
    The FFN width is `ffn_hidden` if given, else mlp_ratio * E, for SwiGLU
    rounded to the JAX package's gate width (2/3 of it, up to a multiple of
    8: 4096 for giant2)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 14,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 ffn_layer: str = "mlp", ffn_hidden: Optional[int] = None,
                 layerscale_init: Optional[float] = 1e-5,
                 pos_embed_grid: int = 37, norm_eps: float = 1e-6,
                 gelu_approximate: bool = True, use_pos_embed: bool = True,
                 use_rope_2d: bool = False, rope_theta: float = 100.0,
                 rope_normalized: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.use_rope_2d = use_rope_2d
        self.rope_theta = rope_theta
        self.rope_normalized = rope_normalized
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if use_pos_embed:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, 1 + pos_embed_grid**2, embed_dim))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, embed_dim))
        if ffn_layer not in ("mlp", "swiglu"):
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        hidden = int(embed_dim * mlp_ratio)
        if ffn_hidden is not None:
            hidden = ffn_hidden
        elif ffn_layer == "swiglu":  # mst_tpu/models/layers.py:82-83
            hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
        for i in range(depth):
            self.add_module(f"blocks_{i}", Block(
                embed_dim, num_heads, hidden, layerscale_init=layerscale_init,
                norm_eps=norm_eps, gelu_approximate=gelu_approximate,
                ffn_layer=ffn_layer))
        self.norm = LayerNorm(embed_dim, norm_eps)

    def block(self, i: int) -> Block:
        return getattr(self, f"blocks_{i}")

    def forward(self, h, rope_cos=None, rope_sin=None, remat: bool = False):
        """The composed encoder (mst_tpu/models/vit.py:135-241) from the
        tokens h [N, S, E] of `vit_fast.prepare_vit_tokens`: every block in
        full (`Block.forward_composed`; the flax path has no CLS-only last
        block), then the final LayerNorm -> CLS [N, E]. With `remat` each
        block runs under `torch.utils.checkpoint`, as `nn.remat` wraps it:
        the backward recomputes the block from its input."""
        for i in range(self.depth):
            blk = self.block(i)
            if remat:
                h = checkpoint(blk.forward_composed, h, rope_cos, rope_sin,
                               use_reentrant=False)
            else:
                h = blk.forward_composed(h, rope_cos, rope_sin)
        return self.norm(h[:, 0])  # the final LN is per token

    def forward_saliency(self, h, rope_cos=None, rope_sin=None,
                         plane_mode: str = "last"):
        """The composed encoder in one saliency mode (serving only), every
        block in full as the flax `return_weights` path runs it -> (CLS [N,
        E], data): "last" the last block's CLS row [N, heads, S];
        "rollout" the reference `get_attention_cls` chain's CLS row, a carry
        [N, heads, S] started one-hot at CLS (as `vit_fast.fused_vit_cls`
        starts it) and moved through every block; "rollout_abnar" the CLS
        row [N, S] of the newest-first product A_l @ ... @ A_0 of the
        blocks' Abnar factors, which `attention.abnar_rollout_row` carries
        back through the blocks after the last one from each block's q, k,
        LSE and row normaliser (no factor and no [S, S] product is made).
        All f32."""
        n, s = h.shape[:2]
        data = None
        if plane_mode == "rollout":
            data = torch.zeros(n, self.num_heads, s, device=h.device)
            data[:, :, 0] = 1.0
        kept = []
        for i in range(self.depth):
            blk = self.block(i)
            if plane_mode == "rollout":
                h, data = blk.forward_composed(h, rope_cos, rope_sin,
                                               carry=data)
            elif plane_mode == "rollout_abnar":
                h, state = blk.forward_composed(h, rope_cos, rope_sin,
                                                abnar=True)
                kept.append(state)
            elif i == self.depth - 1:
                h, data = blk.forward_composed(h, rope_cos, rope_sin,
                                               want_row=True)
            else:
                h = blk.forward_composed(h, rope_cos, rope_sin)
        if plane_mode == "rollout_abnar":
            data = abnar_rollout_row(kept)
        return self.norm(h[:, 0]), data
