"""Model / dataset registries keyed by the reference's CLI names.

Counterpart of `mst_tpu/registry.py` for what the port runs: the
`DinoV2ClassifierSlice` model, with the reference's default optimizer
settings in its entry (lr 1e-6, weight decay 1e-2, `mst/models/dino.py:41`),
and the hermetic `Synthetic` dataset. The other names raise
`NotImplementedError` with the ROADMAP item that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from mst_tpu_torch.models.mst import dino_v2_classifier_slice


@dataclass(frozen=True)
class ModelEntry:
    build: Callable[..., torch.nn.Module]
    learning_rate: float
    weight_decay: float = 1e-2


MODELS: Dict[str, ModelEntry] = {
    "DinoV2ClassifierSlice": ModelEntry(dino_v2_classifier_slice,
                                        learning_rate=1e-6),
}
_NOT_YET = {
    "DinoV3ClassifierSlice": "#7",
    "ResNet": "#8",
    "ResNetSliceTrans": "#8",
}
_DATASETS_NOT_YET = ("LIDC", "DUKE", "MRNet")  # the host data path, #5


def model_entry(name: str) -> ModelEntry:
    if name in _NOT_YET:
        raise NotImplementedError(
            f"{name} is not ported to mst_tpu_torch yet (ROADMAP queue A "
            f"{_NOT_YET[name]})")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODELS)}")
    return MODELS[name]


def get_model(name: str, dtype=torch.float32, **overrides) -> torch.nn.Module:
    """-> the model, holding zero-initialised parameters; load weights with
    `models.convert.params_from_flax`."""
    entry = model_entry(name)
    overrides.setdefault("out_ch", 2)
    return entry.build(dtype=dtype, **overrides)


def get_dataset(name: str, split, **kw):
    """`Synthetic` -> the in-memory dataset (seed 0/1/2 for train/val/test,
    as the JAX registry); the reference datasets raise until the host data
    path is ported."""
    if name in _DATASETS_NOT_YET:
        raise NotImplementedError(
            f"dataset {name} is not ported to mst_tpu_torch yet (ROADMAP "
            f"queue A #5)")
    if name != "Synthetic":
        raise ValueError(f"unknown dataset {name!r}")
    from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D

    seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
    return Synthetic_Dataset3D(seed=seed, **kw)
