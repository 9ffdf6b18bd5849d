"""MRNet knee-MRI dataset.

Counterpart of `mst_tpu/data/datasets/mrnet.py` (the reference's
`mst/data/datasets/dataset_3d_mrnet.py`): the sagittal stacks
`preprocessed/data/{Folder}/sagittal/{ID:04d}.nii.gz` and
`preprocessed/splits/split.csv`, sorted by the label column descending in
pandas' order (ties everywhere: the labels are 0 / 1, and the order decides
which file index i reads), the two transposes, CropOrPad to (32, 150, 150)
with minimum padding on the host, then on the card Resize(32, 224, 224)
-> percentile ZNorm((0, 100)) -> z-rotation -> flips -> inversion -> noise
(sigma <= 0.25). An all-ones LabelMap rides through the same geometry
(padded with 0), so the per-slice key padding mask comes out of the device
pipeline as `~(mask.sum(H, W) > 0)`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mst_tpu_torch.data.datasets.base import Dataset3D
from mst_tpu_torch.data.transforms import AugmentConfig, crop_or_pad


class MRNet_Dataset3D(Dataset3D):
    LABEL = "meniscus"

    def __init__(
        self,
        path_root,
        fold: int = 0,
        split: Optional[str] = None,
        fraction: Optional[float] = None,
        flip: bool = False,
        random_rotate: bool = False,
        random_center: bool = False,
        noise: bool = False,
        label: Optional[str] = None,
        seed: int = 0,
        decode_cache=None,
    ):
        super().__init__(path_root, split, decode_cache=decode_cache)
        if label is not None:
            self.LABEL = label
        df = self.load_split(
            self.path_root / "preprocessed" / "splits" / "split.csv",
            fold=fold, split=split, fraction=fraction)
        self.df = df.sort_desc(self.LABEL).reset_index(drop=True)
        self.item_pointers = self.df.index.tolist()
        self.flip, self.random_rotate, self.noise = flip, random_rotate, noise
        self.random_center = random_center
        self.rng = np.random.default_rng(seed)

    def augment_config(self, train: bool) -> AugmentConfig:
        return AugmentConfig(
            znorm_percentiles=(0.0, 100.0),
            resize_to=(32, 224, 224),
            random_rotate=self.random_rotate,
            flip=self.flip,
            invert=self.noise,
            noise_std=0.25 if self.noise else 0.0,
            has_mask=True,
        )

    def nifti_paths(self, index) -> list:
        item = self.df.loc(self.item_pointers[index])
        return [self.path_root / "preprocessed" / "data" / str(item["Folder"])
                / "sagittal" / f"{int(item['ID']):04d}.nii.gz"]

    def __getitem__(self, index):
        item = self.df.loc(self.item_pointers[index])
        dhw, affine = self._read_volume(self.nifti_paths(index)[0])
        # the stored [X = S, Y, Z] stack's X is the slice axis; the
        # reference's transpose(-1, 1) and tensor swap net out to this
        vol = np.swapaxes(np.swapaxes(dhw, 0, 2)[None], 2, 3)
        mask_bg = np.ones_like(vol, dtype=np.uint8)[:1]
        vol, mask_bg = crop_or_pad(vol, (32, 150, 150), mask=None,
                                   random_center=self.random_center,
                                   rng=self.rng, extra=[mask_bg])
        # [D, H, W] = [X, Z, Y] after the transposes
        sx, sy, sz = np.abs(np.diag(affine)[:3])
        return {
            "uid": int(item["ID"]),
            "source": vol.astype(np.float32),
            "mask": mask_bg.astype(np.uint8),
            "target": int(item[self.LABEL]),
            "affine": affine,
            "spacing_dhw": np.array([sx, sz, sy]),
            "needs_padding_mask": True,
        }
