"""Carry parameters between the JAX package and the port's modules.

The port's modules use the flax parameter names, so the adapter is a name
map: the flat key `encoder/blocks_0/attn/qkv/kernel` (keys joined with "/",
as `flax.traverse_util.flatten_dict(params, sep="/")` gives them) is the
module attribute `encoder.blocks_0.attn.qkv.kernel`. Every array keeps its
flax shape and layout: Dense kernels stay `[in, out]`, which is the
row-major `[K, N]` layout the CUDA kernels read, the patch kernel stays
HWIO `[p, p, C, E]`. A quantized flax tree (`mst_tpu`'s
`quantize_mst_params_int8`: `q8` / `scale` / `bias` / `a_inv` nodes and
folded LN vectors) becomes a quantized copy of the model
(`quantized_from_flax`), each such node a `QDense` with those buffers.
"""

from __future__ import annotations

import copy
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


def quantized_from_flax(model: torch.nn.Module,
                        flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """A copy of `model` holding the flat `/`-keyed quantized flax tree
    `flat`: every Dense whose node has `q8` becomes a `QDense` of that
    node's arrays (int8 codes, f32 scale, bias and `a_inv` if present), on
    the model's device; the other leaves go through `params_from_flax`.
    `model` itself is left as it is."""
    from mst_tpu_torch.models.layers import QDense

    qmodel = copy.deepcopy(model)
    device = next(qmodel.parameters()).device
    nodes = sorted(k[:-len("/q8")] for k in flat if k.endswith("/q8"))
    for node in nodes:
        parent, name = node.rsplit("/", 1)
        leaf = {k: flat.get(f"{node}/{k}") for k in ("scale", "bias",
                                                      "a_inv")}
        setattr(qmodel.get_submodule(parent.replace("/", ".")), name,
                QDense(*(None if a is None else torch.from_numpy(
                    np.array(a, dt)).to(device) for a, dt in (
                        (flat[f"{node}/q8"], np.int8),
                        (leaf["scale"], np.float32),
                        (leaf["bias"], np.float32),
                        (leaf["a_inv"], np.float32)))))
    rest = {k: v for k, v in flat.items() if k.rsplit("/", 1)[0] not in nodes}
    return params_from_flax(qmodel, rest)


def flax_params_from_torch(model: torch.nn.Module) -> dict:
    """The way back: `model`'s parameters as a flat `/`-keyed dict of numpy
    f32 arrays in the flax names and shapes (what `params_from_flax` reads,
    and what `flax.traverse_util.unflatten_dict(..., sep="/")` turns into a
    flax tree)."""
    return {name.replace(".", "/"): p.detach().cpu().float().numpy()
            for name, p in model.named_parameters()}


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
