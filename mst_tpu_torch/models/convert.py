"""Load the JAX package's parameters into the port's modules.

The port's modules use the flax parameter names, so the adapter is a name
map: the flat key `encoder/blocks_0/attn/qkv/kernel` (keys joined with "/",
as `flax.traverse_util.flatten_dict(params, sep="/")` gives them) is the
module attribute `encoder.blocks_0.attn.qkv.kernel`. Every array keeps its
flax shape and layout: Dense kernels stay `[in, out]`, which is the
row-major `[K, N]` layout the CUDA kernels read, the patch kernel stays
HWIO `[p, p, C, E]`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_flax(model: torch.nn.Module,
                     flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy a flat `/`-keyed flax parameter dict into `model` (in place, on
    the model's device, as f32). Raises KeyError on a missing or an unused
    key and ValueError on a shape mismatch. Returns the model."""
    named = dict(model.named_parameters())
    want = {k.replace(".", "/") for k in named}
    given = set(flat)
    missing, unused = sorted(want - given), sorted(given - want)
    if missing or unused:
        raise KeyError(f"params_from_flax: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, unused "
                       f"{unused[:8]}{'...' if len(unused) > 8 else ''}")
    with torch.no_grad():
        for name, param in named.items():
            arr = np.array(flat[name.replace(".", "/")], np.float32)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: flax shape {arr.shape} != "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
    return model


def random_flax_params(model: torch.nn.Module, seed: int) -> dict:
    """A seeded random parameter tree for `model`, flat and `/`-keyed like
    the flax tree, drawn the way the flax initialisers draw: truncated
    normal(0.02) for cls / pos / register tokens, normal(0.02) for the
    slice position table, LeCun normal for kernels, zero biases, unit LN
    scales, LayerScale at `model.layerscale_init`. Only the numpy generator
    seeded with `seed` is used."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, param in model.named_parameters():
        key = name.replace(".", "/")
        shape = tuple(param.shape)
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("cls_token", "pos_embed", "register_tokens"):
            arr = np.clip(rng.standard_normal(shape), -2.0, 2.0) * 0.02
        elif leaf == "embedding":
            arr = rng.standard_normal(shape) * 0.02
        elif leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            arr = np.ones(shape)
        elif leaf == "gamma":
            arr = np.full(shape, model.layerscale_init)
        elif leaf == "bias":
            arr = np.zeros(shape)
        else:
            raise KeyError(f"random_flax_params: no initialiser for {key}")
        out[key] = arr.astype(np.float32)
    return out
