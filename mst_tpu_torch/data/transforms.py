"""Train-time augmentation as batched torch ops on the volumes' device.

Counterpart of the `flip` and `noise_std` steps of
`mst_tpu/data/transforms.py` `_augment_one` (`DeviceAugment`): per sample,
three flip flags with p = 0.5 over (D, H, W), applied to the volume,
then Gaussian noise of a std drawn from U(0, noise_std). Each sample's
draws come from its own `torch.Generator` on the volumes' device, seeded
with the sample's 32-bit key (the crc32 the DataModule derives as the JAX
one does); the flips and the noise then run on the whole batch at once.
Those generators are Philox (CUDA) or the Mersenne twister (CPU), not JAX's
threefry, so the draws do not match the JAX pipeline bit for bit: the
distributions do. Every other `AugmentConfig` field raises: intensity
normalisation, resizing, rotation and inversion come with the host data
path (ROADMAP queue A #5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's augmentation config (same fields and defaults)."""

    clamp_range: Optional[Tuple[float, float]] = None
    rescale: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None
    znorm_percentiles: Optional[Tuple[float, float]] = None
    resize_to: Optional[Tuple[int, int, int]] = None
    random_rotate: bool = False
    flip: bool = False
    invert: bool = False
    noise_std: float = 0.0  # sigma ~ U(0, noise_std)
    has_mask: bool = False


_LATER = ("clamp_range", "rescale", "znorm_percentiles", "resize_to",
          "random_rotate", "invert")


def check_supported(cfg: AugmentConfig) -> None:
    for name in _LATER:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"AugmentConfig.{name} is not ported to mst_tpu_torch yet "
                f"(ROADMAP queue A #5)")


def augment_batch(cfg: AugmentConfig, train: bool, vol: torch.Tensor,
                  seeds: Sequence[int]) -> torch.Tensor:
    """vol [B, C, D, H, W] (any float dtype; returned in f32), one seed per
    sample -> the augmented batch."""
    check_supported(cfg)
    vol = vol.float()
    if not train or not (cfg.flip or cfg.noise_std > 0.0):
        return vol
    b = vol.shape[0]
    flags, noise = [], []
    for seed in seeds:
        gen = torch.Generator(device=vol.device)
        gen.manual_seed(int(seed))
        if cfg.flip:
            flags.append(torch.rand(3, generator=gen, device=vol.device) < 0.5)
        if cfg.noise_std > 0.0:
            sigma = torch.rand((), generator=gen, device=vol.device)
            noise.append(sigma * cfg.noise_std * torch.randn(
                vol.shape[1:], generator=gen, device=vol.device))
    if cfg.flip:
        flags = torch.stack(flags)  # [B, 3]
        for i, ax in enumerate((2, 3, 4)):
            f = flags[:, i].view(b, 1, 1, 1, 1)
            vol = torch.where(f, vol.flip(ax), vol)
    if noise:
        vol = vol + torch.stack(noise)
    return vol
