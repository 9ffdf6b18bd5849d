"""Attention-based 3D saliency maps as plain functions.

Counterpart of `mst_tpu/ops/saliency.py` (the reference's
`mst/models/dino.py:169-212` + `scripts/main_predict.py:55-106`), with the
same map semantics:

- slice attention: the CLS->slice row of the fusion attention, normalised
  to sum 1 per head, then the mean over heads;
- plane attention: the CLS->patch row of the last ViT block, prefix
  (CLS + register) tokens skipped, patch 0 zeroed, normalised per head,
  then the head mean;
- combined map: the outer product of the two;
- `attention_cls_rollout`: the reference `get_attention_cls` chain;
  `attention_rollout` / `attention_rollout_from_factors` /
  `attention_rollout_from_row`: the Abnar & Zuidema variant (opt-in).

Every function takes and returns torch tensors on any device; the chains
are `torch.matmul` in f32, as XLA runs them in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def slice_attention(fusion_probs: torch.Tensor) -> torch.Tensor:
    """[B, heads, S, S] fusion attention (S = 1 + D, CLS first) ->
    per-slice weights [B, D]: each head's CLS row normalised before the
    head mean."""
    cls_row = fusion_probs[:, :, 0, 1:]  # [B, heads, D]
    w = cls_row / cls_row.sum(-1, keepdim=True).clamp_min(1e-12)
    return w.mean(1)


def plane_attention(vit_probs: torch.Tensor, num_prefix_tokens: int,
                    grid_hw) -> torch.Tensor:
    """[BD, heads, T, T] last-block ViT attention -> [BD, gh, gw]."""
    return plane_attention_from_row(vit_probs[:, :, 0], num_prefix_tokens,
                                    grid_hw)


def plane_attention_from_row(cls_row: torch.Tensor, num_prefix_tokens: int,
                             grid_hw) -> torch.Tensor:
    """`plane_attention` from the CLS row [BD, heads, T] alone (what the
    `with_row` / `rollout` kernels emit): patch 0 zeroed, normalised per
    head, head mean -> [BD, gh, gw]."""
    w = cls_row[:, :, num_prefix_tokens:].clone()  # [BD, heads, N]
    w[:, :, 0] = 0.0
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-12)
    gh, gw = grid_hw
    return w.mean(1).reshape(-1, gh, gw)


def combined_saliency(slice_w: torch.Tensor,
                      plane_w: torch.Tensor) -> torch.Tensor:
    """slice [B, D] x plane [B*D, gh, gw] -> [B, D, gh, gw]."""
    b, d = slice_w.shape
    plane = plane_w.reshape(b, d, *plane_w.shape[1:])
    return slice_w[:, :, None, None] * plane


def attention_cls_rollout(probs_per_layer: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
    """The reference `get_attention_cls`: A_0 @ A_1 @ ... @ A_{L-1} over the
    raw per-head probabilities [B, heads, T, T] (no identity, no
    normalisation, heads kept), multiplied from the last layer back."""
    result = probs_per_layer[-1]
    for a in reversed(probs_per_layer[:-1]):
        result = torch.matmul(a, result)
    return result


def _cls_rollout_row(result: torch.Tensor, num_prefix_tokens: int):
    cls_row = result[:, 0, num_prefix_tokens:]
    return cls_row / cls_row.sum(-1, keepdim=True).clamp_min(1e-12)


def attention_rollout_from_factors(factors: Sequence[torch.Tensor],
                                   num_prefix_tokens: int) -> torch.Tensor:
    """`attention_rollout` from per-layer factors [B, T, T] that already
    hold head mean + I + row normalisation (what `mhsa_abnar` emits): the
    newest-first product, CLS row read and normalised -> [B, N]."""
    result = None
    for a in factors:
        result = a if result is None else torch.matmul(a, result)
    return _cls_rollout_row(result, num_prefix_tokens)


def attention_rollout_from_row(row: torch.Tensor,
                               num_prefix_tokens: int) -> torch.Tensor:
    """`attention_rollout` from the CLS row [B, T] of the factors' product
    (what `attention.abnar_rollout_row` carries back through the blocks):
    read from the first patch on and normalised -> [B, N]."""
    return _cls_rollout_row(row[:, None], num_prefix_tokens)


def attention_rollout(probs_per_layer: Sequence[torch.Tensor],
                      num_prefix_tokens: int) -> torch.Tensor:
    """Abnar & Zuidema rollout over all layers -> CLS->patch map [B, N]:
    per layer head mean + full identity, row-normalised, multiplied down
    the stack."""
    factors = []
    for probs in probs_per_layer:
        a = probs.mean(1)
        a = a + torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        factors.append(a / a.sum(-1, keepdim=True))
    return attention_rollout_from_factors(factors, num_prefix_tokens)


def upsample_saliency(saliency: torch.Tensor, out_shape) -> torch.Tensor:
    """Trilinear upsample [B, D, gh, gw] -> [B, *out_shape] f32: half-pixel
    centres with clamped edges, `jax.image.resize(..., "trilinear")` for an
    upsampling."""
    return F.interpolate(saliency.float()[:, None], size=tuple(out_shape),
                         mode="trilinear", align_corners=False)[:, 0]
