"""Inference: class probabilities and 3D saliency, with batched flip-TTA.

Counterpart of `mst_tpu/train/predictor.py` `make_predict_fn`, routed as
it routes (:238-257): the serving forward (`models/vit_fast.mst_logits`:
the fused path, or above `FUSED_MAX_TOKENS` tokens per slice the composed
path, which an int8-quantized model refuses with JAX's `ValueError`) or,
with saliency, the fused explainability forward
(`models/vit_fast.fused_mst_saliency`: slice attention x plane attention,
upsampled to the volume grid), softmax in f32, and the 8-way flip TTA run
as ONE batch (the flip stack is a leading batch axis; probabilities average
after the softmax; each saliency map is flipped back before the mean; a
variant that flips the slice axis flips the key-padding mask too).
Saliency above `FUSED_MAX_TOKENS` tokens (JAX's flax `return_weights`
path, which runs no kernel) is ROADMAP queue A #16; Grad-CAM for the
ResNet baselines is ROADMAP queue A #8.
"""

from __future__ import annotations

import itertools

import torch

from mst_tpu_torch.models.vit_fast import (
    FUSED_MAX_TOKENS,
    fused_mst_saliency,
    fused_seq_len_ok,
    has_int8,
    mst_logits,
)

FLIP_SUBSETS = [
    s for n in range(4) for s in itertools.combinations((1, 2, 3), n)
]  # spatial axes of [C, D, H, W] per-sample layout; 8 subsets incl. ()


def make_predict_fn(model, tta: bool = False, with_saliency: bool = True,
                    plane_mode: str = "last"):
    """Returns fn(source [B, C, D, H, W], mask [B, D] | None) ->
    (probs [B, n_classes] f32, saliency [B, D, H, W] f32 | None), tensors on
    the model's device. `plane_mode` selects the saliency map: "last" (the
    reference's default, the last block's CLS row), "rollout" (the
    reference `get_attention_cls` chain) or "rollout_abnar" (Abnar &
    Zuidema, opt-in).

    The port's parameters live in `model` (an nn.Module), so unlike the JAX
    predict fn this one takes no params argument. `source` and `mask` may be
    numpy arrays or tensors; they are moved to the model's device."""
    device = next(model.parameters()).device

    def forward(source, mask):
        if not with_saliency:
            return torch.softmax(mst_logits(model, source, mask), -1), None
        if not fused_seq_len_ok(model, *source.shape[-2:]):
            if has_int8(model):  # JAX's order (:248-255)
                raise ValueError(
                    "int8-quantized params need the fused serving path; "
                    "this saliency input exceeds FUSED_MAX_TOKENS")
            raise NotImplementedError(
                f"saliency of {tuple(source.shape[-2:])} slices (above "
                f"FUSED_MAX_TOKENS={FUSED_MAX_TOKENS} tokens) is not ported "
                f"to mst_tpu_torch yet (ROADMAP queue A #16)")
        return fused_mst_saliency(model, source, mask, plane_mode=plane_mode)

    @torch.inference_mode()
    def fn(source, mask=None):
        source = torch.as_tensor(source).to(device, torch.float32)
        if mask is not None:
            mask = torch.as_tensor(mask).to(device, torch.bool)
        if not tta:
            return forward(source, mask)
        b = source.shape[0]
        stacked = torch.cat([
            torch.flip(source, dims=[a + 1 for a in s]) if s else source
            for s in FLIP_SUBSETS], dim=0)  # [8B, C, D, H, W]
        m = None
        if mask is not None:
            m = torch.cat([torch.flip(mask, dims=[1]) if 1 in s else mask
                           for s in FLIP_SUBSETS], dim=0)
        probs, sal = forward(stacked, m)
        probs = probs.reshape(len(FLIP_SUBSETS), b, -1).mean(0)
        if sal is not None:
            # sal[i] [B, D, H, W] has D, H, W at axes 1-3, as [C, D, H, W]
            sal = sal.reshape(len(FLIP_SUBSETS), b, *sal.shape[1:])
            sal = torch.stack([torch.flip(sal[i], dims=list(s)) if s
                               else sal[i]
                               for i, s in enumerate(FLIP_SUBSETS)]).mean(0)
        return probs, sal

    return fn
