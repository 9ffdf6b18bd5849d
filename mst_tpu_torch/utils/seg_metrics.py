"""Segmentation metrics of `predict --get_segmentation`: Dice, IoU and the
average symmetric surface distance.

Counterpart of `mst_tpu/utils/seg_metrics.py` (the reference's MONAI
`compute_dice` / `compute_iou` / `compute_average_surface_distance`,
`scripts/main_predict.py:243-256`), on the host in numpy and scipy: the
surface distance from scipy's exact Euclidean distance transform in
physical units (`spacing` in the volume's (D, H, W) order).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice_score(pred: np.ndarray, target: np.ndarray) -> float:
    """Binary Dice over the whole volume; NaN when both masks are empty."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    denom = pred.sum() + target.sum()
    if denom == 0:
        return float("nan")
    return float(2.0 * np.logical_and(pred, target).sum() / denom)


def iou_score(pred: np.ndarray, target: np.ndarray) -> float:
    """Binary intersection over union; NaN when both masks are empty."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    union = np.logical_or(pred, target).sum()
    if union == 0:
        return float("nan")
    return float(np.logical_and(pred, target).sum() / union)


def _surface_mask(x: np.ndarray) -> np.ndarray:
    """The boundary voxels of a binary mask: the mask less its erosion by
    the 6-connected cross."""
    x = np.asarray(x).astype(bool)
    if not x.any():
        return x
    eroded = ndimage.binary_erosion(
        x, structure=ndimage.generate_binary_structure(x.ndim, 1),
        border_value=0)
    return x & ~eroded


def average_surface_distance(pred: np.ndarray, target: np.ndarray,
                             spacing=None, symmetric: bool = True) -> float:
    """The mean distance from each surface voxel of one mask to the other
    mask's surface, both ways with `symmetric` (MONAI's semantics), in the
    units of `spacing`; NaN when either surface is empty."""
    pred_s = _surface_mask(pred)
    target_s = _surface_mask(target)
    if not pred_s.any() or not target_s.any():
        return float("nan")
    d_pt = ndimage.distance_transform_edt(~target_s, sampling=spacing)[pred_s]
    if not symmetric:
        return float(d_pt.mean())
    d_tp = ndimage.distance_transform_edt(~pred_s, sampling=spacing)[target_s]
    return float(np.concatenate([d_pt, d_tp]).mean())


def saliency_to_mask(saliency: np.ndarray, quantile: float = 0.999) -> np.ndarray:
    """The voxels above the saliency's `quantile` (taken in f64) -> a binary
    mask (reference `main_predict.py:243-247`)."""
    thr = np.quantile(np.asarray(saliency, dtype=np.float64), quantile)
    return np.asarray(saliency) > thr
