"""MST slice classifier: per-slice ViT encoder + slice fusion + head.

Counterpart of `mst_tpu/models/mst.py` `DinoSliceClassifier`: a DINOv2 ViT
(learned pos-embed, optional register tokens; ViT-S/B/L with an MLP FFN,
giant2 with a SwiGLU FFN) or a DINOv3 ViT (2D RoPE instead of a learned
pos-embed, 4 registers, patch 16, LN eps 1e-5; either FFN); the slice
fusion `transformer` (a volume CLS token, the fusion layers, optionally
with RoPE or LiRE on their attention, and the fusion norm), `average` (the
mean over the valid slices) or `linear` / `none` (the flat [B, D * e]
features straight into the head, whose width D * e is fixed at
construction: `num_slices`); optional bottleneck and slice position
embedding, `freeze` (the encoder trains frozen: the reference's giant2
workflow) and `remat` (an unfrozen encoder recomputes each block in the
backward instead of keeping its residuals: what fits unfrozen ViT-L and
giant2 on one card). The module holds the parameters under the flax names.
Slices of up to `vit_fast.FUSED_MAX_TOKENS` tokens run the fused path
(`models/vit_fast.fused_mst_logits`) in every fusion: only the fusion,
plain PyTorch, differs; the module's own forward is the composed path,
flax `encode_slices` + `__call__`, which longer slices take
(`vit_fast.mst_logits` routes). An encoder train step the fused CUDA
kernels cannot run (`check_trainable`) raises before its forward.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from mst_tpu_torch.models.layers import Dense, LayerNorm
from mst_tpu_torch.models.slice_fusion import ROTARY, TransformerEncoderLayer
from mst_tpu_torch.models.vit import _VIT_CONFIGS, VisionTransformer
from mst_tpu_torch.models.vit_fast import (
    FastViTConfig,
    fusion_head,
    prepare_vit_tokens,
    slices_nhwc,
)
from mst_tpu_torch.ops.fused_block import LN_PULLBACK_MAX_K

MAX_SLICES = 256  # slice-position vocabulary (reference `dino.py:81-82`)
SLICE_FUSIONS = ("transformer", "linear", "average", "none")
# The slice count a `linear` / `none` head is built for unless given: the
# reference's (`dino.py:99` hard-codes 32 slices; flax infers it from the
# first batch, the port's CLIs from theirs and from a checkpoint's head)
LINEAR_SLICES = 32


class _Embed(nn.Module):
    """flax `nn.Embed` parameter: embedding [vocab, dim]."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab, dim))


class DinoSliceClassifier(nn.Module):
    """MST-DINO classifier (v2 and v3 are configurations of it). `dtype` is
    the compute dtype of the serving forward (bf16 on the card); parameters
    stay f32. `config` holds the options it was built with (what a run
    folder's hparams record, so that `serve.load_run_model` rebuilds it).
    `ffn_layer` None takes the size's FFN (SwiGLU for giant2); `freeze`
    trains the slice fusion and head on a fixed encoder; `remat`
    checkpoints each encoder block of the train step (`mst_tpu`'s field:
    the same values, less memory, one more forward). `num_slices` is the
    slice count D of a `linear` / `none` head [D * e, out_ch] (default
    LINEAR_SLICES); the other fusions take any D."""

    def __init__(self, out_ch: int = 2, model_size: str = "small",
                 patch_size: int = 14, num_register_tokens: int = 0,
                 slice_fusion: str = "transformer", fusion_layers: int = 1,
                 fusion_heads: int = 12, rotary: Optional[str] = None,
                 use_bottleneck: bool = False, use_rope_2d: bool = False,
                 use_slice_pos_emb: bool = False,
                 pos_embed_grid: int = 37, use_pos_embed: bool = True,
                 rope_theta: float = 100.0, rope_normalized: bool = False,
                 norm_eps: float = 1e-6, ffn_layer: Optional[str] = None,
                 ffn_hidden: Optional[int] = None,
                 layerscale_init: Optional[float] = 1e-5,
                 gelu_approximate: bool = True, freeze: bool = False,
                 remat: bool = False, num_slices: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if model_size not in _VIT_CONFIGS:
            raise ValueError(f"unknown model_size {model_size!r}")
        base = _VIT_CONFIGS[model_size]
        ffn_layer = ffn_layer or base.get("ffn_layer", "mlp")
        if slice_fusion not in SLICE_FUSIONS:
            raise ValueError(f"unknown slice_fusion {slice_fusion!r}")
        if rotary not in ROTARY:
            raise ValueError(f"unknown rotary mode {rotary!r}")
        if slice_fusion == "transformer" and fusion_layers < 1:
            raise ValueError("transformer slice fusion needs fusion_layers >= 1")
        if use_rope_2d and (base["embed_dim"] // base["num_heads"]) % 4:
            raise ValueError("the 2D RoPE needs a head dim divisible by 4")
        self.config = dict(
            model_size=model_size, slice_fusion=slice_fusion, rotary=rotary,
            patch_size=patch_size,
            num_register_tokens=num_register_tokens,
            fusion_layers=fusion_layers, fusion_heads=fusion_heads,
            use_bottleneck=use_bottleneck, use_rope_2d=use_rope_2d,
            use_slice_pos_emb=use_slice_pos_emb, pos_embed_grid=pos_embed_grid,
            use_pos_embed=use_pos_embed, rope_theta=rope_theta,
            rope_normalized=rope_normalized, norm_eps=norm_eps,
            ffn_layer=ffn_layer, ffn_hidden=ffn_hidden,
            layerscale_init=layerscale_init,
            gelu_approximate=gelu_approximate, freeze=freeze, remat=remat)
        # only what the forward and `random_flax_params` read is kept
        self.model_size = model_size
        self.slice_fusion = slice_fusion
        self.rotary = rotary
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.fusion_layers = fusion_layers
        self.use_bottleneck = use_bottleneck
        self.use_slice_pos_emb = use_slice_pos_emb
        self.pos_embed_grid = pos_embed_grid
        self.norm_eps = norm_eps
        self.layerscale_init = layerscale_init
        self.gelu_approximate = gelu_approximate
        self.ffn_layer = ffn_layer
        self.freeze = freeze
        self.remat = remat
        self.dtype = dtype

        self.encoder = VisionTransformer(
            embed_dim=base["embed_dim"], depth=base["depth"],
            num_heads=base["num_heads"], patch_size=patch_size,
            num_register_tokens=num_register_tokens, ffn_layer=ffn_layer,
            ffn_hidden=ffn_hidden,
            layerscale_init=layerscale_init, pos_embed_grid=pos_embed_grid,
            norm_eps=norm_eps, gelu_approximate=gelu_approximate,
            use_pos_embed=use_pos_embed, use_rope_2d=use_rope_2d,
            rope_theta=rope_theta, rope_normalized=rope_normalized)
        if freeze:
            # the JAX `multi_transform` with `set_to_zero` on the encoder:
            # no grad, so AdamW neither steps nor decays it
            self.encoder.requires_grad_(False)
        emb = base["embed_dim"]
        if use_bottleneck:
            self.bottleneck = Dense(emb, emb // 4)
            emb //= 4
        self.emb_ch = emb
        if use_slice_pos_emb:
            self.slice_pos_emb = _Embed(MAX_SLICES, emb)
        head_in = emb
        if slice_fusion == "transformer":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, emb))
            for i in range(fusion_layers):
                self.add_module(f"fusion_{i}", TransformerEncoderLayer(
                    emb, fusion_heads, emb, rotary=rotary))
            self.fusion_norm = LayerNorm(emb, 1e-5)
        elif slice_fusion in ("linear", "none"):
            self.num_slices = num_slices or LINEAR_SLICES
            head_in = self.num_slices * emb
        self.head = Dense(head_in, out_ch)

    def fusion(self, i: int) -> TransformerEncoderLayer:
        return getattr(self, f"fusion_{i}")

    def check_trainable(self, device) -> None:
        """Raise, before any forward work, where a fused train step that
        reaches into the encoder cannot run on `device`: on a CUDA device, an
        encoder whose widths the train kernels do not take (the LN pullback
        of `gemm_dgrad` wants E % 128 == 0 and E <= LN_PULLBACK_MAX_K, the
        attention kernels a head dim of 64, the FFN's `gemm_dgrad` an FFN
        width % 128 == 0). Every DINOv2 size (ViT-S/B/L, giant2) passes; the
        CPU path trains any width, and a frozen encoder trains at any
        size."""
        if self.freeze or torch.device(device).type != "cuda":
            return
        enc = self.encoder
        e, heads = enc.embed_dim, enc.num_heads
        mlp = enc.block(0).mlp
        hidden = (mlp.w3 if self.ffn_layer == "swiglu" else mlp.fc2
                  ).kernel.shape[0]
        missing = [what for what, bad in (
            (f"embed_dim % 128 == 0 and <= {LN_PULLBACK_MAX_K} (the LN "
             f"pullback of gemm_dgrad)", e % 128 or e > LN_PULLBACK_MAX_K),
            ("a head dim of 64 (mhsa, mhsa_bwd)", e != 64 * heads),
            ("an FFN width % 128 == 0 (gemm_dgrad)", hidden % 128))
            if bad]
        if missing:
            raise NotImplementedError(
                f"training the encoder of this model (embed_dim={e}, "
                f"{heads} heads, FFN width {hidden}) on CUDA needs "
                f"{'; '.join(missing)}: the hand-written train kernels take "
                f"no other widths (ROADMAP queue A #12); train it with "
                f"--freeze, or on the CPU")

    def forward(self, source, src_key_padding_mask=None, train: bool = False,
                dtype: Optional[torch.dtype] = None):
        """The composed path: source [B, C, D, H, W] -> logits [B, out_ch]
        (f32), the counterpart of flax `encode_slices` + `__call__`
        (mst_tpu/models/mst.py:147-228). Every encoder block runs in full
        (`VisionTransformer.forward`), differentiable by autograd; with
        `freeze` under `torch.no_grad()` (JAX's `stop_gradient` on the
        features), with `train` and `remat` each block checkpointed.
        `dtype` defaults to `self.dtype`; float64 on the plain attention is
        the oracle. Any width runs here (the flash kernels hold the head
        dim to 64 on CUDA)."""
        dtype = self.dtype if dtype is None else dtype
        b, d = source.shape[0], source.shape[2]
        grad = torch.no_grad() if self.freeze else contextlib.nullcontext()
        with grad:
            h, rope_cos, rope_sin = prepare_vit_tokens(
                self.encoder, slices_nhwc(source),
                FastViTConfig.from_model(self), dtype)
            feats = self.encoder(h, rope_cos, rope_sin,
                                 remat=train and self.remat)
        return fusion_head(self, feats, b, d, src_key_padding_mask, dtype)[0]


def dino_v2_classifier_slice(**kw) -> DinoSliceClassifier:
    """Reference `DinoV2ClassifierSlice` defaults (`dino.py:33-51`)."""
    kw.setdefault("model_size", "small")
    kw.setdefault("patch_size", 14)
    kw.setdefault("slice_fusion", "transformer")
    return DinoSliceClassifier(**kw)


def dino_v3_classifier_slice(**kw) -> DinoSliceClassifier:
    """Reference `DinoV3ClassifierSlice` (`dino.py:279-795`) with the
    defaults of `mst_tpu/models/mst.py:239-258`: patch 16 and 4 register
    tokens, no learned pos-embed (normalised 2D RoPE, theta 100), LN eps
    1e-5. A gated-MLP DINOv3 checkpoint sets `ffn_layer="swiglu"` and its
    `ffn_hidden`."""
    kw.setdefault("model_size", "small")
    kw.setdefault("patch_size", 16)
    kw.setdefault("num_register_tokens", 4)
    kw.setdefault("slice_fusion", "transformer")
    kw.setdefault("use_rope_2d", True)
    kw.setdefault("rope_normalized", True)
    kw.setdefault("use_pos_embed", False)
    kw.setdefault("norm_eps", 1e-5)
    return DinoSliceClassifier(**kw)
