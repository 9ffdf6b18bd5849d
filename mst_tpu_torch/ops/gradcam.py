"""Grad-CAM / Grad-CAM++ as plain functions over (activation, gradient).

Counterpart of `mst_tpu/ops/gradcam.py`: the model exposes `features()`
(the final ReLU map) and `classify()`, and the gradient of the argmax
logit (summed over the batch) with respect to that map comes from one
backward through `classify` alone, never through the backbone (JAX's
`jax.grad` over the activation). `grad_cam_weights` is eq. 19 of
Grad-CAM++ (arXiv:1710.11063, the reference's `resnet.py:105-122`);
`grad_cam_map` adds the ReLU and the per-map min / max normalisation of
`resnet.py:93-103`.
"""

from __future__ import annotations

import torch


def grad_cam_weights(grads: torch.Tensor, act: torch.Tensor,
                     mode: str = "gradcam++") -> torch.Tensor:
    """grads / act [B, C, *spatial] -> weights [B, C, 1...]."""
    spatial = tuple(range(2, grads.ndim))
    if mode == "gradcam":
        return grads.mean(spatial, keepdim=True)
    if mode != "gradcam++":
        raise ValueError(f"unknown CAM mode {mode!r}")
    g2 = grads ** 2
    g3 = g2 * grads
    sum_act = act.sum(spatial, keepdim=True)
    denom = 2.0 * g2 + sum_act * g3 + 1e-6
    denom = torch.where(denom != 0.0, denom, torch.ones_like(denom))
    aij = g2 / denom
    return (torch.relu(grads) * aij).sum(spatial, keepdim=True)


def grad_cam_map(act: torch.Tensor, grads: torch.Tensor,
                 mode: str = "gradcam++") -> torch.Tensor:
    """-> the normalised CAM [B, 1, *spatial]."""
    w = grad_cam_weights(grads, act, mode)
    cam = torch.relu((w * act).sum(1, keepdim=True))
    flat = cam.reshape(cam.shape[0], -1)
    view = (-1,) + (1,) * (cam.ndim - 1)
    mn = flat.amin(-1).reshape(view)
    mx = flat.amax(-1).reshape(view)
    return (cam - mn) / torch.clamp(mx - mn, min=1e-12)


def argmax_logit_grads(act: torch.Tensor, head_fn):
    """(logits, d(sum of each row's argmax logit) / d act) of `head_fn` on
    the activation `act` (detached first, so the backward ends there);
    `head_fn` returns the logits, or a tuple whose first item they are,
    which is returned whole."""
    with torch.enable_grad():
        a = act.detach().requires_grad_(True)
        out = head_fn(a)
        logits = out[0] if isinstance(out, tuple) else out
        idx = logits.detach().argmax(1)
        score = logits.gather(1, idx[:, None]).sum()
        (grads,) = torch.autograd.grad(score, a)
    if isinstance(out, tuple):
        return tuple(o.detach() if torch.is_tensor(o) else o
                     for o in out), grads
    return logits.detach(), grads


def argmax_logit_gradcam(features_fn, classify_fn, x,
                         mode: str = "gradcam++"):
    """The Grad-CAM pipeline -> (logits, cam [B, 1, *spatial]):
    `features_fn` x -> the final ReLU map [B, C, *spatial], run without
    grad; `classify_fn` map -> logits [B, n_cls]; the backward target is
    the argmax logit summed over the batch (reference `resnet.py:66-69`)."""
    with torch.no_grad():
        act = features_fn(x)
    logits, grads = argmax_logit_grads(act, classify_fn)
    return logits, grad_cam_map(act, grads, mode)
