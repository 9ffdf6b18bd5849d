"""Model / dataset registries keyed by the reference's CLI names.

Counterpart of `mst_tpu/registry.py`: the models `DinoV2ClassifierSlice`
and `DinoV3ClassifierSlice` (lr 1e-6, weight decay 1e-2,
`mst/models/dino.py:41`), `ResNet` (the 3D ResNet50 baseline) and
`ResNetSliceTrans` (MST-ResNet, a 2D ResNet34 per slice) (lr 1e-4,
`base_model.py:125`); the reference datasets `LIDC`, `DUKE` and `MRNet`
read from a `path_root` folder, and the hermetic `Synthetic` dataset.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from mst_tpu_torch.models.mst import (
    dino_v2_classifier_slice,
    dino_v3_classifier_slice,
)
from mst_tpu_torch.models.resnet import ResNet3DClassifier, ResNetSliceTrans


@dataclass(frozen=True)
class ModelEntry:
    build: Callable[..., torch.nn.Module]
    learning_rate: float
    weight_decay: float = 1e-2


def _fields_of(cls, **kw) -> torch.nn.Module:
    """`cls` built from the options of `kw` it takes, the rest dropped, as
    the JAX registry filters by the flax dataclass fields."""
    takes = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kw.items() if k in takes})


def _build_resnet(**kw) -> ResNet3DClassifier:
    kw.setdefault("variant", 50)
    return _fields_of(ResNet3DClassifier, **kw)


def _build_resnet_slice_trans(**kw) -> ResNetSliceTrans:
    return _fields_of(ResNetSliceTrans, **kw)  # variant 34, 16 heads


MODELS: Dict[str, ModelEntry] = {
    "DinoV2ClassifierSlice": ModelEntry(dino_v2_classifier_slice,
                                        learning_rate=1e-6),
    "DinoV3ClassifierSlice": ModelEntry(dino_v3_classifier_slice,
                                        learning_rate=1e-6),
    "ResNet": ModelEntry(_build_resnet, learning_rate=1e-4),
    "ResNetSliceTrans": ModelEntry(_build_resnet_slice_trans,
                                   learning_rate=1e-4),
}


def model_entry(name: str) -> ModelEntry:
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODELS)}")
    return MODELS[name]


def get_model(name: str, dtype=torch.float32, **overrides) -> torch.nn.Module:
    """-> the model, holding zero-initialised parameters (and a ResNet's
    BatchNorm statistics at mean 0, var 1); load weights with
    `models.convert.params_from_flax`."""
    entry = model_entry(name)
    overrides.setdefault("out_ch", 2)
    return entry.build(dtype=dtype, **overrides)


def get_dataset(name: str, split, path_root=None, **kw):
    """The dataset `name` on `split`, as the JAX registry builds it: LIDC,
    DUKE and MRNet read the folder `path_root` (`decode_cache`: the
    decoded-volume disk cache); `Synthetic` is in memory (seed 0/1/2 for
    train/val/test) and ignores `path_root` and the options it has no use
    for (random_center, random_rotate, fold, decode_cache)."""
    if name == "Synthetic":
        from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D

        for key in ("random_center", "random_rotate", "fold", "decode_cache"):
            kw.pop(key, None)
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        return Synthetic_Dataset3D(split=split, seed=seed, **kw)
    if name == "LIDC":
        from mst_tpu_torch.data.datasets.lidc import LIDC_Dataset3D as cls
    elif name == "DUKE":
        from mst_tpu_torch.data.datasets.duke import DUKE_Dataset3D as cls
    elif name == "MRNet":
        from mst_tpu_torch.data.datasets.mrnet import MRNet_Dataset3D as cls
    else:
        raise ValueError(f"unknown dataset {name!r}")
    if path_root is None:
        raise ValueError(f"dataset {name} reads its files from a folder: "
                         f"give path_root (the CLIs' --path_root)")
    return cls(path_root, split=split, **kw)
