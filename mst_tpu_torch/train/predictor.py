"""Inference: class probabilities with batched flip-TTA.

Counterpart of `mst_tpu/train/predictor.py` `make_predict_fn` without
saliency: the fused serving forward (`models/vit_fast.fused_mst_logits`),
softmax in f32, and the 8-way flip TTA run as ONE batch (the flip stack is
a leading batch axis; probabilities average after the softmax; a variant
that flips the slice axis flips the key-padding mask too). Saliency is
ROADMAP queue A #6.
"""

from __future__ import annotations

import itertools

import torch

from mst_tpu_torch.models.vit_fast import fused_mst_logits

FLIP_SUBSETS = [
    s for n in range(4) for s in itertools.combinations((1, 2, 3), n)
]  # spatial axes of [C, D, H, W] per-sample layout; 8 subsets incl. ()


def make_predict_fn(model, tta: bool = False, with_saliency: bool = False):
    """Returns fn(source [B, C, D, H, W], mask [B, D] | None) ->
    (probs [B, n_classes] f32 tensor on the model's device, None).

    The port's parameters live in `model` (an nn.Module), so unlike the JAX
    predict fn this one takes no params argument. `source` and `mask` may be
    numpy arrays or tensors; they are moved to the model's device."""
    if with_saliency:
        raise NotImplementedError(
            "saliency is not ported to mst_tpu_torch yet (ROADMAP queue A #6)")
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fn(source, mask=None):
        source = torch.as_tensor(source).to(device, torch.float32)
        if mask is not None:
            mask = torch.as_tensor(mask).to(device, torch.bool)
        if not tta:
            return torch.softmax(fused_mst_logits(model, source, mask), -1), None
        b = source.shape[0]
        stacked = torch.cat([
            torch.flip(source, dims=[a + 1 for a in s]) if s else source
            for s in FLIP_SUBSETS], dim=0)  # [8B, C, D, H, W]
        m = None
        if mask is not None:
            m = torch.cat([torch.flip(mask, dims=[1]) if 1 in s else mask
                           for s in FLIP_SUBSETS], dim=0)
        probs = torch.softmax(fused_mst_logits(model, stacked, m), -1)
        return probs.reshape(len(FLIP_SUBSETS), b, -1).mean(0), None

    return fn
