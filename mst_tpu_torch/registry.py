"""Model registry keyed by the reference's CLI names.

Counterpart of `mst_tpu/registry.py` `get_model` for the model the port
serves. The other names raise `NotImplementedError` with the ROADMAP item
that brings them; datasets come with the data-path slice (queue A #5), and
the training fields of a registry entry with the training slice (#4).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mst_tpu_torch.models.mst import dino_v2_classifier_slice

MODELS: Dict[str, Callable[..., torch.nn.Module]] = {
    "DinoV2ClassifierSlice": dino_v2_classifier_slice,
}
_NOT_YET = {
    "DinoV3ClassifierSlice": "#7",
    "ResNet": "#8",
    "ResNetSliceTrans": "#8",
}


def get_model(name: str, dtype=torch.float32, **overrides) -> torch.nn.Module:
    """-> the model, holding zero-initialised parameters; load weights with
    `models.convert.params_from_flax`."""
    if name in _NOT_YET:
        raise NotImplementedError(
            f"{name} is not ported to mst_tpu_torch yet (ROADMAP queue A "
            f"{_NOT_YET[name]})")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODELS)}")
    overrides.setdefault("out_ch", 2)
    return MODELS[name](dtype=dtype, **overrides)
