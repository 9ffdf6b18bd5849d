"""Volume transforms: host geometry in numpy, augmentation as batched torch
ops on the volumes' device.

Counterpart of `mst_tpu/data/transforms.py`, in the same split:

1. **Host geometry** (`crop_or_pad`, `ensure_shape_multiple`): ragged
   volumes are cropped or padded to the static target shape in numpy, with
   torchio `CropOrPad` semantics (mask-centred crops, `pad_value=None` as
   `padding_mode='minimum'`, the reference's `random_center` drawn from the
   dataset's numpy generator). The same code as the JAX package's, so the
   windows agree bit for bit.
2. **Device pipeline** (`augment_batch`): on `[B, C, D, H, W]` in
   `_augment_one`'s order: clamp -> rescale -> trilinear resize (and the
   mask) -> percentile z-norm -> z-rotation (and the mask) -> flips (and
   the mask) -> inversion -> Gaussian noise. `draw_augment` draws each
   sample's angle, flip flags, inversion and noise from its own
   `torch.Generator` on the volumes' device, seeded with the sample's
   32-bit key (the crc32 the DataModule derives as the JAX one does);
   `apply_augment` applies given draws to the whole batch at once. Those
   generators are Philox (CUDA) or the Mersenne twister (CPU), not JAX's
   threefry: the distributions match the JAX pipeline, the draws do not,
   so the tests hand both packages the same draws.

The device ops follow the JAX expressions in f32: `rotate_z` computes
`map_coordinates`' source coordinates and taps as JAX does (the fill per
tap, not `grid_sample`'s zero padding), and `resize_trilinear` builds
`jax.image.resize`'s antialiased triangle weights in f32 and applies them
by one product per axis. No op reads a value back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host geometry
# ---------------------------------------------------------------------------


def _split_amount(n: int, random_center: bool,
                  rng: Optional[np.random.Generator]):
    """torchio bound split: ini = ceil(n / 2), or uniform in [0, n] with
    random_center (reference `augmentations_3d.py:166-189`)."""
    if random_center and rng is not None:
        ini = int(rng.integers(0, n + 1))
    else:
        ini = int(np.ceil(n / 2))
    return ini, n - ini


def crop_or_pad(
    vol: np.ndarray,  # [C, D, H, W]
    target_dhw: Tuple[int, int, int],
    mask: Optional[np.ndarray] = None,  # [1, D, H, W] crop centred on its bbox
    random_center: bool = False,
    rng: Optional[np.random.Generator] = None,
    pad_value: Optional[float] = None,  # None => 'minimum'
    extra: Sequence[np.ndarray] = (),
) -> Tuple[np.ndarray, ...]:
    """Crop / pad the spatial axes to `target_dhw` -> (vol, mask?, *extra),
    all windowed identically. With `mask` the window centres on the mask's
    bounding box (torchio `CropOrPad(mask_name=...)`), clamped inside the
    padded volume; the padding fills the volume with `pad_value` (default
    its minimum) and the mask and extras with 0."""
    _, d, h, w = vol.shape
    tgt = tuple(int(t) for t in target_dhw)
    pad_widths = [(0, 0)] + [_split_amount(max(t - s, 0), random_center, rng)
                             for t, s in zip(tgt, (d, h, w))]
    needs_pad = any(p for pw in pad_widths for p in pw)
    # the minimum is a full scan: taken only when padding happens (LIDC's
    # fixed-size crops never pad)
    if pad_value is not None:
        fill = float(pad_value)
    elif needs_pad:
        fill = float(vol.min())
    else:
        fill = 0.0

    def _pad(x, value):
        return np.pad(x, pad_widths, constant_values=value) if needs_pad else x

    vol_p = _pad(vol, fill)
    outs = [vol_p]
    if mask is not None:
        outs.append(_pad(mask, 0))
    outs.extend(_pad(e, 0) for e in extra)

    shape_p = vol_p.shape[1:]
    # the bounding box from axis projections (two any-reductions, not a
    # full np.nonzero)
    nz_axes = None
    if mask is not None:
        m = mask[0] != 0
        proj_dh = m.any(axis=2)  # [D, H]
        if proj_dh.any():
            nz_axes = [np.flatnonzero(proj_dh.any(axis=1)),
                       np.flatnonzero(proj_dh.any(axis=0)),
                       np.flatnonzero(m.any(axis=(0, 1)))]
    if nz_axes is not None:
        center = [int((a[0] + a[-1] + 1) // 2) + pw[0]
                  for a, pw in zip(nz_axes, pad_widths[1:])]
    else:
        center = [s // 2 for s in shape_p]

    starts = []
    for t, s, c in zip(tgt, shape_p, center):
        excess = s - t
        if random_center and rng is not None and mask is None:
            start = int(rng.integers(0, excess + 1)) if excess > 0 else 0
        else:
            start = int(np.clip(c - int(np.ceil(t / 2)), 0, excess))
        starts.append(start)

    sl = (slice(None),) + tuple(slice(st, st + t) for st, t in zip(starts, tgt))
    return tuple(np.ascontiguousarray(o[sl]) for o in outs)


def ensure_shape_multiple(vol: np.ndarray, multiple, method: str = "pad",
                          pad_value: Optional[float] = None,
                          extra: Sequence[np.ndarray] = ()):
    """Pad (or crop) the spatial axes to the next multiple (torchio
    `EnsureShapeMultiple` with the reference's `padding_mode`); `multiple`
    is a scalar or per axis (D, H, W)."""
    mult = np.broadcast_to(np.asarray(multiple, np.int64), (3,))
    fn = np.floor if method == "crop" else np.ceil
    src = np.asarray(vol.shape[1:], np.int64)
    target = np.maximum((fn(src / mult) * mult).astype(np.int64), 1)
    return crop_or_pad(vol, tuple(int(t) for t in target),
                       pad_value=pad_value, extra=extra)


# ---------------------------------------------------------------------------
# Device ops on [B, C, D, H, W]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's augmentation config (same fields and defaults)."""

    clamp_range: Optional[Tuple[float, float]] = None  # LIDC (-1000, 1000)
    # ((out_lo, out_hi), (in_lo, in_hi)): LIDC ((-1, 1), (-1000, 1000))
    rescale: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None
    znorm_percentiles: Optional[Tuple[float, float]] = None  # DUKE / MRNet
    resize_to: Optional[Tuple[int, int, int]] = None  # MRNet (32, 224, 224)
    random_rotate: bool = False  # z-rotation, angle ~ U(0, pi / 2)
    flip: bool = False
    invert: bool = False  # random intensity inversion
    noise_std: float = 0.0  # sigma ~ U(0, noise_std)
    has_mask: bool = False  # a mask rides along through the geometry ops


def clamp(vol, lo, hi):
    return torch.clamp(vol, lo, hi)


def rescale_intensity(vol, out_range=(-1.0, 1.0),
                      in_min_max=(-1000.0, 1000.0)):
    """Linear map `in_min_max` -> `out_range`, clipped (torchio
    `RescaleIntensity(in_min_max=...)`)."""
    in_lo, in_hi = in_min_max
    out_lo, out_hi = out_range
    x = torch.clamp(vol, in_lo, in_hi)
    return (x - in_lo) / (in_hi - in_lo) * (out_hi - out_lo) + out_lo


def _quantile_sorted(srt, count, percentile: float):
    """jnp.nanpercentile's linear interpolation on rows sorted with their
    NaNs last: `count` [N, 1] valid entries; q = percentile / 100 divided
    in the rows' dtype, as JAX divides."""
    dt = np.float64 if srt.dtype == torch.float64 else np.float32
    q = float(dt(percentile) / dt(100.0))  # exact in the rows' dtype
    pos = (count - 1) * q
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    low = low.clamp(min=0).minimum(count - 1).long()
    high = high.clamp(min=0).minimum(count - 1).long()
    return (srt.gather(1, low) * (1 - hw) + srt.gather(1, high) * hw)


ZNORM_EPS = 1e-8  # the std's floor


def znorm_percentile(vol, percentiles=(0.5, 99.5)):
    """Percentile-clipped z-normalisation of each channel of each volume
    ([B, C, D, H, W], batched as [B*C, D*H*W]): clip to the percentiles of
    the voxels strictly between the channel's minimum and maximum (all
    voxels of a constant channel), then subtract their mean and divide by
    their population std, floored at ZNORM_EPS."""
    shape = vol.shape
    x = vol.reshape(shape[0] * shape[1], -1)
    m = (x > x.amin(1, keepdim=True)) & (x < x.amax(1, keepdim=True))
    m = m | ~m.any(1, keepdim=True)
    count = m.sum(1, keepdim=True).to(x.dtype)
    srt = torch.sort(torch.where(m, x, torch.nan), dim=1).values
    lo = _quantile_sorted(srt, count, percentiles[0])
    hi = _quantile_sorted(srt, count, percentiles[1])
    del srt
    x = torch.minimum(torch.maximum(x, lo), hi)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mean = torch.where(m, x, zero).sum(1, keepdim=True) / count
    var = torch.where(m, x - mean, zero).square().sum(1, keepdim=True) / count
    std = torch.sqrt(var)
    out = (x - mean) / torch.maximum(std, torch.full_like(std, ZNORM_EPS))
    return out.reshape(shape)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] f32 weights of `jax.image.resize(..., "trilinear")`
    along one axis (antialiased: a downsampling triangle is widened by the
    scale), built in f32 on `device` as JAX builds them (no copy from the
    host, which would wait for the work queued before it)."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)
            [:, None]).abs()
    kernel_scale = torch.full_like(dist, max(inv_scale, 1.0))
    w = torch.clamp(1 - (dist / kernel_scale).abs(), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_trilinear(vol, target_dhw):
    """[B, C, D, H, W] -> [B, C, *target_dhw] (torchio `Resize`), as
    `jax.image.resize(..., "trilinear")`: one weight product per axis whose
    size changes."""
    for ax, n_out in zip((2, 3, 4), target_dhw):
        n_in = vol.shape[ax]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, int(n_out), vol.device).to(vol.dtype)
        vol = torch.movedim(torch.movedim(vol, ax, -1) @ w, -1, ax)
    return vol.contiguous()


def _round_half_away(x):
    """`lax.round`'s default: ties away from zero (exact: x - trunc(x) is
    exact, where floor(x + 0.5) would round 0.49999997 up)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x),
                           torch.zeros_like(x))


def rotate_z(vol, angle, fill=None, nearest: bool = False):
    """Rotate each volume's in-plane (H, W) axes by its `angle` [B] (radians)
    about the slice centre (torchio `RandomAffine` about the anatomical z
    axis, our slice axis): `jax.scipy.ndimage.map_coordinates` with
    mode="constant", bilinear (`nearest`: ties rounded away from zero, as
    `lax.round`, for masks).
    A tap outside the plane reads `fill` [B] (default: each volume's
    minimum over all of [C, D, H, W]) instead of the voxel."""
    b, c, d, h, w = vol.shape
    if fill is None:
        fill = vol.amin(dim=(1, 2, 3, 4))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=vol.dtype, device=vol.device) - cy)[:, None]
    xx = (torch.arange(w, dtype=vol.dtype, device=vol.device) - cx)[None, :]
    cos = torch.cos(angle).to(vol.dtype).view(b, 1, 1)
    sin = torch.sin(angle).to(vol.dtype).view(b, 1, 1)
    src_y = cos * yy - sin * xx + cy  # [B, H, W]
    src_x = sin * yy + cos * xx + cx
    if nearest:
        taps_y = [(_round_half_away(src_y), None)]
        taps_x = [(_round_half_away(src_x), None)]
    else:
        low_y, low_x = torch.floor(src_y), torch.floor(src_x)
        wy, wx = src_y - low_y, src_x - low_x
        taps_y = [(low_y, 1 - wy), (low_y + 1, wy)]
        taps_x = [(low_x, 1 - wx), (low_x + 1, wx)]
    planes = vol.reshape(b, c * d, h * w)
    if torch.is_tensor(fill):
        fill = fill.to(vol.dtype).view(b, 1, 1)
    else:  # a fill kernel, not a copy from the host
        fill = torch.full((b, 1, 1), fill, dtype=vol.dtype, device=vol.device)
    out = None
    for iy, wy_ in taps_y:
        for ix, wx_ in taps_x:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
            idx = idx.view(b, 1, h * w).expand(b, c * d, h * w)
            tap = torch.where(valid.view(b, 1, h * w), planes.gather(2, idx),
                              fill)
            if wy_ is not None:
                tap = (wy_ * wx_).view(b, 1, h * w) * tap
            out = tap if out is None else out + tap
    return out.view(b, c, d, h, w)


def apply_flips(vol, flags, axes=(2, 3, 4)):
    """flags [B, 3] bool: flip each volume's (D, H, W) axes where set."""
    b = vol.shape[0]
    for i, ax in enumerate(axes):
        f = flags[:, i].view(b, *([1] * (vol.dim() - 1)))
        vol = torch.where(f, vol.flip(ax), vol)
    return vol


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def draw_augment(cfg: AugmentConfig, train: bool, seeds: Sequence[int],
                 shape_cdhw, device) -> Dict[str, torch.Tensor]:
    """Each sample's draws from its own generator on `device`, seeded with
    its key, in this order: the angle ~ U(0, pi / 2) (random_rotate), three
    flip flags with p = 0.5 (flip), the inversion flag with p = 0.5
    (invert), sigma ~ U(0, noise_std) and the standard normal noise at
    the pipeline's output shape `shape_cdhw` (noise_std > 0) -> the stacked
    draws [B, ...] (the noise already scaled by sigma); none outside
    training."""
    if not train:
        return {}
    device = torch.device(device)
    names = [n for n, on in (("angle", cfg.random_rotate), ("flip", cfg.flip),
                             ("invert", cfg.invert),
                             ("noise", cfg.noise_std > 0.0)) if on]
    out = {n: [] for n in names}
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        if cfg.random_rotate:
            out["angle"].append(torch.rand((), generator=gen, device=device)
                                * (math.pi / 2))
        if cfg.flip:
            out["flip"].append(torch.rand(3, generator=gen, device=device)
                               < 0.5)
        if cfg.invert:
            out["invert"].append(torch.rand((), generator=gen, device=device)
                                 < 0.5)
        if cfg.noise_std > 0.0:
            sigma = torch.rand((), generator=gen, device=device)
            out["noise"].append(sigma * cfg.noise_std * torch.randn(
                tuple(shape_cdhw), generator=gen, device=device))
    return {n: torch.stack(v) for n, v in out.items()}


def apply_augment(cfg: AugmentConfig, vol: torch.Tensor,
                  mask: Optional[torch.Tensor], draws: Dict) -> tuple:
    """vol [B, C, D, H, W] (any float dtype, computed in f32, or in f64 when
    given f64), mask [B, 1, D, H, W] or None -> (vol, mask) through
    `_augment_one`'s steps; the random ones where `draws` holds their draw
    (`draw_augment`). A mask comes back bool once a geometry op moved it."""
    if vol.dtype != torch.float64:
        vol = vol.float()
    if cfg.clamp_range is not None:
        vol = clamp(vol, *cfg.clamp_range)
    if cfg.rescale is not None:
        out_range, in_min_max = cfg.rescale
        vol = rescale_intensity(vol, out_range, in_min_max)
    # the resize comes BEFORE the z-norm: the reference MRNet chain is
    # CropOrPad -> Resize -> ZNormalization, so the statistics are taken
    # on the resized volume
    if cfg.resize_to is not None:
        vol = resize_trilinear(vol, cfg.resize_to)
        if mask is not None:
            mask = resize_trilinear(mask.to(vol.dtype), cfg.resize_to) > 0.5
    if cfg.znorm_percentiles is not None:
        vol = znorm_percentile(vol, cfg.znorm_percentiles)
    if "angle" in draws:
        vol = rotate_z(vol, draws["angle"])
        if mask is not None:
            mask = rotate_z(mask.to(vol.dtype), draws["angle"], fill=0.0,
                            nearest=True) > 0.5
    if "flip" in draws:
        vol = apply_flips(vol, draws["flip"])
        if mask is not None:
            mask = apply_flips(mask, draws["flip"])
    if "invert" in draws:
        vol = torch.where(draws["invert"].view(-1, 1, 1, 1, 1), -vol, vol)
    if "noise" in draws:
        vol = vol + draws["noise"].to(vol.dtype)
    return vol, mask


def augment_batch(cfg: AugmentConfig, train: bool, vol: torch.Tensor,
                  seeds: Sequence[int], mask: Optional[torch.Tensor] = None):
    """The device pipeline on a batch: draws from `seeds` (one per sample),
    then `apply_augment`. -> vol, or (vol, mask) when a mask is given."""
    shape = (vol.shape[1], *(cfg.resize_to or vol.shape[2:]))
    draws = draw_augment(cfg, train, seeds, shape, vol.device)
    out, mask = apply_augment(cfg, vol, mask, draws)
    return out if mask is None else (out, mask)
