"""DUKE breast DCE-MRI dataset.

Counterpart of `mst_tpu/data/datasets/duke.py` (the reference's
`mst/data/datasets/dataset_3d_duke.py`): the packed `data_compressed.h5`
(`Breast_MRI_{uid:03d}/sub` and `sub_affine`) read by the native HDF5
reader (`native/h5lite.cpp`; there is no h5py on the card's machine), the
UID zero-padding, one row per patient (`drop_duplicates(PatientID,
keep="first")`), the [C, W, H, D] -> [C, D, H, W] swap with the Flip(1)
view fix, CropOrPad to (32, 224, 224) with minimum padding and random
centre on the host, then on the card percentile ZNorm((0.5, 99.5),
extremes masked) -> z-rotation -> flips -> inversion -> noise
(sigma <= 0.25).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mst_tpu_torch.data.datasets.base import Dataset3D
from mst_tpu_torch.data.transforms import AugmentConfig, crop_or_pad


class DUKE_Dataset3D(Dataset3D):
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
        decode_cache=None,
    ):
        super().__init__(path_root, split, decode_cache=decode_cache)
        self.path_h5 = self.path_root / "data_compressed.h5"
        df = self.load_split(self.path_root / "splits" / "split.csv",
                             fold=fold, split=split, fraction=fraction)
        self.df = df.drop_duplicates("PatientID").reset_index(drop=True)
        self.item_pointers = self.df.index.tolist()
        self.crop_dhw = None if image_crop is None else (
            image_crop[2], image_crop[1], image_crop[0])
        self.random_center = random_center
        self.flip, self.random_rotate, self.noise = flip, random_rotate, noise
        self.rng = np.random.default_rng(seed)

    def augment_config(self, train: bool) -> AugmentConfig:
        return AugmentConfig(
            znorm_percentiles=(0.5, 99.5),
            random_rotate=self.random_rotate,
            flip=self.flip,
            invert=self.noise,
            noise_std=0.25 if self.noise else 0.0,
        )

    @staticmethod
    def format_uid(uid) -> str:
        """'1_left' -> '001_left'; 7 -> '007' (reference :75-87)."""
        uid = str(uid)
        if "_" in uid:
            num, rest = uid.split("_", 1)
            return f"{num.zfill(3)}_{rest}"
        return uid.zfill(3)

    def _patient_id(self, index) -> str:
        item = self.df.loc(self.item_pointers[index])
        return f"Breast_MRI_{self.format_uid(item['UID'])}"

    def h5_items(self, index) -> list:
        pid = self._patient_id(index)
        return [(self.path_h5, f"{pid}/sub"),
                (self.path_h5, f"{pid}/sub_affine")]

    def __getitem__(self, index):
        item = self.df.loc(self.item_pointers[index])
        pid = self._patient_id(index)
        vol = np.asarray(self._read_h5(self.path_h5, f"{pid}/sub"),
                         np.float32)
        affine = self._read_h5(self.path_h5, f"{pid}/sub_affine")
        if vol.ndim == 3:
            vol = vol[None]
        # torchio [C, W, H, D] -> [C, D, H, W], then the Flip(1) view fix
        # (torchio's H axis)
        vol = np.swapaxes(vol, 1, 3)[:, :, ::-1]
        if self.crop_dhw is not None:
            (vol,) = crop_or_pad(vol, self.crop_dhw,
                                 random_center=self.random_center,
                                 rng=self.rng)
        sx, sy, sz = np.abs(np.diag(np.asarray(affine))[:3])
        return {
            "uid": str(item["UID"]),
            "source": vol.astype(np.float32),
            "target": int(item[self.LABEL]),
            "affine": affine,
            "spacing_dhw": np.array([sz, sy, sx]),
        }
