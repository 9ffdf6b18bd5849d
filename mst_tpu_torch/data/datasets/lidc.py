"""LIDC-IDRI CT lung-nodule dataset.

Counterpart of `mst_tpu/data/datasets/lidc.py` (the reference's
`mst/data/datasets/dataset_3d_lidc.py`): the same files
(`preprocessed/splits/split.csv`, per-nodule `img_{n}.nii.gz`, the
consensus `seg_{n}.nii.gz` and, on the test split, each rater's
`seg_{n}_{r}.nii.gz`), the mask-centred CropOrPad to (D, H, W) = (32, 224,
224) with minimum padding and random centre on the host, then on the card
Clamp(-1000, 1000) -> RescaleIntensity((-1, 1)) -> z-rotation -> flips ->
inversion -> noise (sigma <= 0.1). The reference's `moveaxis(1, 2)` view
fix swaps H and W; it is applied after the crop, which commutes with it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mst_tpu_torch.data.datasets.base import Dataset3D
from mst_tpu_torch.data.transforms import AugmentConfig, crop_or_pad


class LIDC_Dataset3D(Dataset3D):
    LABEL = "Malignant"

    def __init__(
        self,
        path_root,
        fold: int = 0,
        split: Optional[str] = None,
        fraction: Optional[float] = None,
        flip: bool = False,
        random_rotate: bool = False,
        image_crop: Optional[Tuple[int, int, int]] = (224, 224, 32),  # W, H, D
        random_center: bool = False,
        noise: bool = False,
        seed: int = 0,
    ):
        super().__init__(path_root, split)
        self.path_root_data = self.path_root / "preprocessed_crop" / "data"
        self.df = self.load_split(
            self.path_root / "preprocessed" / "splits" / "split.csv",
            fold=fold, split=split, fraction=fraction)
        self.item_pointers = self.df.index.tolist()
        # the reference gives the crop as (W, H, D); stored as (D, H, W)
        self.crop_dhw = None if image_crop is None else (
            image_crop[2], image_crop[1], image_crop[0])
        self.random_center = random_center
        self.flip, self.random_rotate, self.noise = flip, random_rotate, noise
        self.rng = np.random.default_rng(seed)

    def augment_config(self, train: bool) -> AugmentConfig:
        return AugmentConfig(
            clamp_range=(-1000.0, 1000.0),
            rescale=((-1.0, 1.0), (-1000.0, 1000.0)),
            random_rotate=self.random_rotate,
            flip=self.flip,
            invert=self.noise,
            noise_std=0.1 if self.noise else 0.0,
            # the nodule mask serves the host (the mask-centred crop, the
            # segmentation scores): it never rides to the card
            has_mask=False,
        )

    def _sample_paths(self, index):
        uid = self.item_pointers[index]
        item = self.df.loc(uid)
        rel_path = (Path(str(item["patient_id"]))
                    / str(item["study_instance_uid"])
                    / str(item["series_instance_uid"]))
        path_dir = self.path_root_data / rel_path
        n = item["nodule_idx"]
        paths = [path_dir / f"img_{n}.nii.gz", path_dir / f"seg_{n}.nii.gz"]
        if self.split == "test":
            paths += [path_dir / f"seg_{n}_{r}.nii.gz"
                      for r in range(int(item["annotation_num"]))]
        return uid, item, rel_path, paths

    def nifti_paths(self, index) -> list:
        return self._sample_paths(index)[3]

    def __getitem__(self, index):
        uid, item, rel_path, paths = self._sample_paths(index)
        img, affine = self._read_volume(paths[0])
        seg, _ = self._read_volume(paths[1])
        vol = img[None]
        mask = (seg > 0)[None]
        rater_masks = [(self._read_volume(p)[0] > 0)[None] for p in paths[2:]]
        # crop on the decode layout, then swap H and W on the small crop
        # (the same window as swap-then-crop with the H / W target swapped)
        if self.crop_dhw is not None:
            tgt = (self.crop_dhw[0], self.crop_dhw[2], self.crop_dhw[1])
            out = crop_or_pad(vol, tgt, mask=mask.astype(np.uint8),
                              random_center=self.random_center, rng=self.rng,
                              extra=rater_masks)
            vol, mask, rater_masks = out[0], out[1] > 0, [m > 0 for m in out[2:]]
        vol = np.swapaxes(vol, 2, 3)
        mask = np.swapaxes(mask, 2, 3)
        rater_masks = [np.swapaxes(m, 2, 3) for m in rater_masks]
        # the volume is [Z, Y, X] with H and W swapped: spacing (sz, sx, sy)
        sx, sy, sz = np.abs(np.diag(affine)[:3])
        sample = {
            "uid": str(uid),
            "source": vol.astype(np.float32),
            "mask": mask.astype(np.uint8),
            "target": int(item[self.LABEL]),
            "affine": affine,
            "spacing_dhw": np.array([sz, sx, sy]),
            "path": str(rel_path),
            "filename": paths[0].name,
        }
        if rater_masks:
            sample["rater_masks"] = np.stack(rater_masks).astype(np.uint8)
        return sample
