"""Synthetic in-memory dataset with the MST sample contract.

Counterpart of `mst_tpu/data/datasets/synthetic.py`: the same numpy draws
from the same seed, so both packages see the same volumes, without the
pandas frame (the port's `labels()` reads the targets directly). Positives
carry a bright Gaussian blob, which a model that learns anything finds
within a few steps. Every sample has the JAX keys: `uid`, `source`,
`target`, `affine` (identity), `path`, the blob's `mask` with `with_mask`,
and on the `"test"` split two raters' copies of it, `rater_masks`, which
`predict --get_segmentation` scores against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mst_tpu_torch.data.transforms import AugmentConfig


class Synthetic_Dataset3D:
    def __init__(
        self,
        num_samples: int = 16,
        shape_cdhw: Tuple[int, int, int, int] = (1, 8, 28, 28),
        split: Optional[str] = None,
        seed: int = 0,
        flip: bool = False,
        noise: bool = False,
        with_mask: bool = True,
        blob_amplitude: float = 3.0,
    ):
        self.split = split
        self.flip, self.noise = flip, noise
        self.with_mask = with_mask
        rng = np.random.default_rng(seed)
        self._targets = (np.arange(num_samples) % 2).astype(int)
        self._vols, self._masks = [], []
        _, d, h, w = shape_cdhw
        zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                 indexing="ij")
        for i in range(num_samples):
            vol = rng.normal(0, 1, shape_cdhw).astype(np.float32)
            mask = np.zeros((1, d, h, w), np.uint8)
            if self._targets[i] == 1:
                cz = rng.integers(d // 4, 3 * d // 4)
                cy = rng.integers(h // 4, 3 * h // 4)
                cx = rng.integers(w // 4, 3 * w // 4)
                r2 = (zz - cz) ** 2 * 4 + (yy - cy) ** 2 + (xx - cx) ** 2
                blob = blob_amplitude * np.exp(-r2 / (2.0 * (h / 8) ** 2))
                vol[0] += blob.astype(np.float32)
                mask[0] = (blob > blob_amplitude * 0.5).astype(np.uint8)
            self._vols.append(vol)
            self._masks.append(mask)

    def __len__(self):
        return len(self._targets)

    def labels(self) -> np.ndarray:
        return self._targets.copy()

    def augment_config(self, train: bool) -> AugmentConfig:
        return AugmentConfig(flip=self.flip,
                             noise_std=0.1 if self.noise else 0.0,
                             has_mask=self.with_mask)

    def __getitem__(self, index):
        sample = {"uid": f"synth_{index:04d}", "source": self._vols[index],
                  "target": int(self._targets[index]), "affine": np.eye(4),
                  "path": f"synthetic/{index:04d}"}
        if self.with_mask:
            sample["mask"] = self._masks[index]
            if self.split == "test":  # two raters agreeing on the blob
                sample["rater_masks"] = np.stack([self._masks[index]] * 2)
        return sample
