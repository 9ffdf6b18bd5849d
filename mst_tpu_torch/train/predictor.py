"""Inference: class probabilities and 3D saliency, with batched flip-TTA.

Counterpart of `mst_tpu/train/predictor.py` `make_predict_fn`, routed as
it routes (:238-257): the serving forward (`models/vit_fast.mst_logits`:
the fused path, or above `FUSED_MAX_TOKENS` tokens per slice the composed
path, which an int8-quantized model refuses with JAX's `ValueError`; a
ResNet's own forward) or, with saliency, `_saliency_fn_for(model)` (:193):
for the MST-DINO models the fused explainability forward
(`models/vit_fast.fused_mst_saliency`: slice attention x plane attention,
upsampled to the volume grid; uniform slice weights 1/D where the fusion
has no attention), for the 3D ResNet Grad-CAM++ of its final map with
the gradient in closed form (`_resnet3d_saliency`), for MST-ResNet the
fusion's slice attention x each slice's Grad-CAM++
(`_resnet_slice_saliency`); softmax in f32, and the 8-way flip TTA run as
ONE batch (the flip stack is a leading batch axis; probabilities average
after the softmax; each saliency map is flipped back before the mean; a
variant that flips the slice axis flips the key-padding mask too).
Above `FUSED_MAX_TOKENS` tokens per slice the saliency forward is the
composed one (`vit_fast.composed_mst_saliency`: JAX's flax
`return_weights` path, which sows every block's probabilities; here the
flash kernels with the CLS-row, carry or Abnar kernel on their LSE), and
an int8-quantized model raises JAX's `ValueError`. The forwards run under
`torch.inference_mode()`, but for the ResNets': `torch.no_grad()`, since
MST-ResNet's Grad-CAM backward needs autograd, the gradient taken from the
final map alone (`ops/gradcam.py`).

`predict_program` is the same function of device tensors with no autograd
context of its own: what `mst_tpu_torch/export.py` traces with
`torch.export`, which cannot trace a backward. So MST-ResNet's saliency,
whose gradient runs back through the slice fusion, raises
NotImplementedError there (ROADMAP queue A #14).
"""

from __future__ import annotations

import itertools

import torch

from mst_tpu_torch.models.vit_fast import (
    fused_config_supported,
    fused_mst_saliency,
    mst_logits,
)
from mst_tpu_torch.ops.gradcam import argmax_logit_grads, grad_cam_map
from mst_tpu_torch.ops.saliency import slice_attention, upsample_saliency

FLIP_SUBSETS = [
    s for n in range(4) for s in itertools.combinations((1, 2, 3), n)
]  # spatial axes of [C, D, H, W] per-sample layout; 8 subsets incl. ()


def _resnet_slice_saliency(model, source, mask, plane_mode=None):
    """MST-ResNet: the fusion's slice attention x each slice's Grad-CAM++
    (reference `resnet.py:200-216`) -> (probs, saliency [B, D, H, W])."""
    del plane_mode
    b, d = source.shape[0], source.shape[2]
    with torch.no_grad():
        feats = model.slice_features(source)  # [B*D, C', H', W']

    def head(a):
        emb = model.slice_embed(a).reshape(b, d, -1)
        return model.fuse(emb, mask, want_probs=True)

    (logits, fusion_probs), grads = argmax_logit_grads(feats, head)
    cam = grad_cam_map(feats, grads)[:, 0]  # [B*D, H', W']
    sw = slice_attention(fusion_probs)  # [B, D]
    cam = cam.reshape(b, d, *cam.shape[1:])
    sal = upsample_saliency(sw[:, :, None, None] * cam, source.shape[2:])
    return torch.softmax(logits.float(), -1), sal


def _resnet3d_saliency(model, source, mask, plane_mode=None):
    """Grad-CAM++ of the 3D ResNet baseline (reference `resnet.py:56-122`,
    `main_predict.py:_pred_resnet`) -> (probs, saliency [B, D, H, W]). The
    gradient of the argmax logit with respect to the final map is taken in
    closed form, with no backward: the logits are `fc` of the map's global
    mean, so it is the argmax class's `fc` column over the map's positions,
    the values autograd gives."""
    del mask, plane_mode
    feats = model.features(source)
    logits = model.classify(feats)
    col = model.fc.kernel.t()[logits.argmax(1)]  # [B, C']
    view = col.shape + (1,) * (feats.ndim - 2)
    grads = (col / feats[0, 0].numel()).reshape(view).expand(feats.shape)
    cam = grad_cam_map(feats, grads)
    sal = upsample_saliency(cam[:, 0], source.shape[2:])
    return torch.softmax(logits.float(), -1), sal


def _resnet_slice_saliency_refused(model, source, mask, plane_mode=None):
    raise NotImplementedError(
        "the MST-ResNet saliency program takes its Grad-CAM++ gradient back "
        "through the slice fusion, which torch.export cannot trace: "
        "exporting it is what is left of ROADMAP queue A #14")


def _dino_saliency(model, source, mask, plane_mode="last"):
    return fused_mst_saliency(model, source, mask, plane_mode=plane_mode)


def _saliency_fn_for(model):
    name = type(model).__name__
    if name == "ResNet3DClassifier":
        return _resnet3d_saliency
    if name == "ResNetSliceTrans":
        return _resnet_slice_saliency
    return _dino_saliency


def _predict_body(model, tta, with_saliency, plane_mode, saliency_fn):
    """fn(source [B, C, D, H, W] f32, mask [B, D] bool | None) on the
    model's device -> (probs, saliency | None), with TTA as one batch."""

    def forward(source, mask):
        if not with_saliency:
            return torch.softmax(mst_logits(model, source, mask), -1), None
        return saliency_fn(model, source, mask, plane_mode)

    def body(source, mask=None):
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

    return body


def predict_program(model, tta: bool = False, with_saliency: bool = True,
                    plane_mode: str = "last"):
    """`make_predict_fn`'s function on device tensors, traceable by
    `torch.export` (module docstring): fn(source [B, C, D, H, W] f32, mask
    [B, D] bool | None) -> (probs, saliency | None). The caller sets the
    autograd mode."""
    saliency_fn = _saliency_fn_for(model)
    if saliency_fn is _resnet_slice_saliency:
        saliency_fn = _resnet_slice_saliency_refused
    return _predict_body(model, tta, with_saliency, plane_mode, saliency_fn)


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
    body = _predict_body(model, tta, with_saliency, plane_mode,
                         _saliency_fn_for(model))
    no_autograd = (torch.inference_mode if fused_config_supported(model)
                   else torch.no_grad)

    @no_autograd()
    def fn(source, mask=None):
        source = torch.as_tensor(source).to(device, torch.float32)
        if mask is not None:
            mask = torch.as_tensor(mask).to(device, torch.bool)
        return body(source, mask)

    return fn
