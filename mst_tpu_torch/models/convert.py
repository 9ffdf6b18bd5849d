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
Pretrained torch state dicts (DINOv2 torch.hub / HuggingFace, HuggingFace
DINOv3, the reference's whole MST, torchvision / MONAI ResNets and the
reference's ResNet baselines) become flat dicts by the converters below
(`--pretrained_path` of the train CLI). A ResNet's BatchNorm statistics
(JAX's `batch_stats` collection) travel beside its parameters as a second
flat dict with the flax keys (`backbone/bn1/mean`, ...).
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch


def _copy_into(named: dict, flat: Mapping[str, np.ndarray],
               what: str) -> None:
    """Copy `flat` into the tensors `named` (torch names), strictly: every
    key once, every shape equal."""
    want = {k.replace(".", "/") for k in named}
    given = set(flat)
    missing, unused = sorted(want - given), sorted(given - want)
    if missing or unused:
        raise KeyError(f"{what}: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, unused "
                       f"{unused[:8]}{'...' if len(unused) > 8 else ''}")
    with torch.no_grad():
        for name, t in named.items():
            arr = np.array(flat[name.replace(".", "/")], np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: flax shape {arr.shape} != "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))


def _stat_buffers(model: torch.nn.Module) -> dict:
    """The BatchNorm running statistics of `model` (the ResNets), by torch
    name: `<bn>.mean`, `<bn>.var`."""
    from mst_tpu_torch.models.resnet import batchnorms

    return {f"{name}.{stat}": getattr(bn, stat)
            for name, bn in batchnorms(model) for stat in ("mean", "var")}


def params_from_flax(model: torch.nn.Module,
                     flat: Mapping[str, np.ndarray],
                     batch_stats: Optional[Mapping[str, np.ndarray]] = None
                     ) -> torch.nn.Module:
    """Copy a flat `/`-keyed flax parameter dict into `model` (in place, on
    the model's device, as f32), and `batch_stats`, the flat flax
    `batch_stats` collection (`backbone/bn1/mean`, ...), into a ResNet's
    BatchNorm statistics where given. Raises KeyError on a missing or an
    unused key and ValueError on a shape mismatch. Returns the model."""
    _copy_into(dict(model.named_parameters()), flat, "params_from_flax")
    if batch_stats is not None:
        _copy_into(_stat_buffers(model), batch_stats,
                   "params_from_flax (batch_stats)")
    return model


def flax_batch_stats_from_torch(model: torch.nn.Module) -> dict:
    """A ResNet's BatchNorm statistics as the flat `/`-keyed flax
    `batch_stats` collection of numpy f32 arrays ({} for a model without
    BatchNorm)."""
    return {name.replace(".", "/"): np.array(t.detach().cpu().float())
            for name, t in _stat_buffers(model).items()}


def initial_batch_stats(model: torch.nn.Module) -> dict:
    """flax's BatchNorm statistics at init: every mean 0, every var 1."""
    return {k: (np.zeros if k.endswith("/mean") else np.ones)(
        v.shape, np.float32)
        for k, v in flax_batch_stats_from_torch(model).items()}


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
    scales, LayerScale at `model.layerscale_init`; for the ResNets LeCun
    normal conv kernels (fan-in k^d * in), unit BN scales, zero BN biases
    and MST-ResNet's CLS token normal(1); LiRE generators normal(0.02).
    Only the numpy generator seeded with `seed` is used."""
    rng = np.random.default_rng(seed)
    out = {}
    resnet_cls = type(model).__name__ == "ResNetSliceTrans"
    for name, param in model.named_parameters():
        key = name.replace(".", "/")
        shape = tuple(param.shape)
        leaf = key.rsplit("/", 1)[-1]
        if key == "cls_token" and resnet_cls:
            arr = rng.standard_normal(shape)
        elif leaf in ("cls_token", "pos_embed", "register_tokens"):
            arr = np.clip(rng.standard_normal(shape), -2.0, 2.0) * 0.02
        elif leaf in ("embedding", "liere_generators"):
            arr = rng.standard_normal(shape) * 0.02
        elif leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.standard_normal(shape)
            arr /= np.sqrt(fan_in)  # in place: giant2 draws 1.15 B values
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


# ---------------------------------------------------------------------------
# Pretrained state dicts (torch.hub / HuggingFace layouts) -> flat flax dicts
# ---------------------------------------------------------------------------
#
# A copy of `mst_tpu/models/convert.py`'s pure-numpy converters (the port
# imports nothing of `mst_tpu`). Each returns the flat `/`-keyed dict that
# `params_from_flax` reads, with the state dict's own dtype:
#
# - torch Linear weight [out, in]    -> Dense kernel [in, out]
# - torch Conv weight [out, in, *k]  -> Conv kernel [*k, in, out] (HWIO)
# - torch LayerNorm weight / bias    -> scale / bias
# - DINOv2's qkv rows ([q; k; v]) are the fused qkv Dense's output order.


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def pos_embed_grid_from_sd(sd) -> int:
    """The canonical pos-embed grid side of a DINOv2 state dict (257 tokens
    -> 16, 1370 -> 37), hub or HF layout."""
    key = "pos_embed" if "pos_embed" in sd else "embeddings.position_embeddings"
    n = np.asarray(sd[key]).shape[1] - 1
    side = int(round(n ** 0.5))
    assert side * side == n, f"non-square pos embed ({n} patch tokens)"
    return side


def detect_encoder_layout(sd) -> str:
    """'hub' (torch.hub DINOv2), 'hf' (HuggingFace Dinov2Model) or 'hf_v3'
    (HuggingFace DINOv3ViTModel)."""
    if "pos_embed" in sd and "cls_token" in sd:
        return "hub"
    if "embeddings.position_embeddings" in sd:
        return "hf"
    if "layer.0.attention.q_proj.weight" in sd:
        return "hf_v3"
    raise ValueError(
        "unrecognised encoder state_dict layout (neither torch.hub DINOv2, "
        "HuggingFace Dinov2Model, nor HuggingFace DINOv3ViTModel keys "
        "present)")


def convert_any_dinov2(sd, depth: int, ffn_layer: str = "mlp",
                       num_heads: Optional[int] = None) -> dict:
    """Dispatch on the state dict's layout: torch.hub or HF (v2 or v3).
    `num_heads` reaches only the v3 converter (its q / k permutation)."""
    layout = detect_encoder_layout(sd)
    if layout == "hub":
        return convert_dinov2_vit(sd, depth, ffn_layer)
    if layout == "hf_v3":
        return convert_hf_dinov3(sd, depth, num_heads)
    return convert_hf_dinov2(sd, depth)


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _conv(w) -> np.ndarray:
    w = np.asarray(w)  # [out, in, *k]
    k = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + k)) + (1, 0))


def _ln(sd, prefix) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _dense(sd, prefix) -> dict:
    return {"kernel": _t(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def convert_dinov2_vit(sd, depth: int, ffn_layer: str = "mlp") -> dict:
    """torch.hub `DinoVisionTransformer` state dict (the reference's
    `mst/models/extern/dinov2/vision_transformer.py` names, plain or
    chunked `blocks.0.{i}` blocks, MLP or SwiGLU `w12` / `w3`) -> the flat
    VisionTransformer dict."""
    params = {
        "cls_token": np.asarray(sd["cls_token"]),
        "pos_embed": np.asarray(sd["pos_embed"]),
        "patch_embed": {"proj": {
            "kernel": _conv(sd["patch_embed.proj.weight"]),
            "bias": np.asarray(sd["patch_embed.proj.bias"])}},
        "norm": _ln(sd, "norm"),
    }
    if "register_tokens" in sd:
        params["register_tokens"] = np.asarray(sd["register_tokens"])
    for i in range(depth):
        p = f"blocks.{i}"
        if f"{p}.norm1.weight" not in sd:  # chunked layout blocks.0.{i}
            p = f"blocks.0.{i}"
        blk = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {"qkv": _dense(sd, f"{p}.attn.qkv"),
                     "proj": _dense(sd, f"{p}.attn.proj")},
        }
        if f"{p}.ls1.gamma" in sd:
            blk["ls1"] = {"gamma": np.asarray(sd[f"{p}.ls1.gamma"])}
            blk["ls2"] = {"gamma": np.asarray(sd[f"{p}.ls2.gamma"])}
        if ffn_layer == "swiglu":
            blk["mlp"] = {"w12": _dense(sd, f"{p}.mlp.w12"),
                          "w3": _dense(sd, f"{p}.mlp.w3")}
        else:
            blk["mlp"] = {"fc1": _dense(sd, f"{p}.mlp.fc1"),
                          "fc2": _dense(sd, f"{p}.mlp.fc2")}
        params[f"blocks_{i}"] = blk
    return _flat(params)


def convert_hf_dinov2(sd, depth: int) -> dict:
    """HuggingFace `Dinov2Model` state dict -> the flat VisionTransformer
    dict: the separate query / key / value projections packed into the
    fused qkv ([q; k; v] output rows)."""
    def g(key):
        return np.asarray(sd[key])

    params = {
        "cls_token": g("embeddings.cls_token"),
        "pos_embed": g("embeddings.position_embeddings"),
        "patch_embed": {"proj": {
            "kernel": _conv(g("embeddings.patch_embeddings.projection.weight")),
            "bias": g("embeddings.patch_embeddings.projection.bias")}},
        "norm": {"scale": g("layernorm.weight"), "bias": g("layernorm.bias")},
    }
    if "embeddings.register_tokens" in sd:
        params["register_tokens"] = g("embeddings.register_tokens")
    for i in range(depth):
        p = f"encoder.layer.{i}"
        a = f"{p}.attention.attention"
        qkv_w = np.concatenate([g(f"{a}.query.weight"), g(f"{a}.key.weight"),
                                g(f"{a}.value.weight")], axis=0)
        qkv_b = np.concatenate([g(f"{a}.query.bias"), g(f"{a}.key.bias"),
                                g(f"{a}.value.bias")], axis=0)
        blk = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {"qkv": {"kernel": qkv_w.T, "bias": qkv_b},
                     "proj": _dense(sd, f"{p}.attention.output.dense")},
        }
        if f"{p}.layer_scale1.lambda1" in sd:
            blk["ls1"] = {"gamma": g(f"{p}.layer_scale1.lambda1")}
            blk["ls2"] = {"gamma": g(f"{p}.layer_scale2.lambda1")}
        if f"{p}.mlp.weights_in.weight" in sd:  # SwiGLU (giant)
            blk["mlp"] = {"w12": _dense(sd, f"{p}.mlp.weights_in"),
                          "w3": _dense(sd, f"{p}.mlp.weights_out")}
        else:
            blk["mlp"] = {"fc1": _dense(sd, f"{p}.mlp.fc1"),
                          "fc2": _dense(sd, f"{p}.mlp.fc2")}
        params[f"blocks_{i}"] = blk
    return _flat(params)


def _interleave_heads(w: np.ndarray, num_heads: int) -> np.ndarray:
    """Permute q / k output features from HF's rotate-half order (pairs
    (i, i + hd/2) in each head) to the interleaved pairs (2i, 2i+1) of
    `ops.rotary`. q.k^T is unchanged by a permutation shared by q and k;
    with it HF DINOv3's RoPE is the port's."""
    w = np.asarray(w)
    hd = w.shape[0] // num_heads
    idx = np.empty((num_heads, hd), np.int64)
    base = np.arange(num_heads)[:, None] * hd
    idx[:, 0::2] = base + np.arange(hd // 2)
    idx[:, 1::2] = base + np.arange(hd // 2) + hd // 2
    return w[idx.reshape(-1)]


def dinov3_config_from_sd(sd) -> dict:
    """The encoder config an HF DINOv3ViTModel state dict carries: patch
    size, register count, width, depth and the FFN (gated `swiglu` or
    `mlp`) with its hidden width."""
    conv = np.asarray(sd["embeddings.patch_embeddings.weight"])
    cfg = {
        "patch_size": int(conv.shape[-1]),
        "num_register_tokens":
            int(np.asarray(sd["embeddings.register_tokens"]).shape[1]),
        "embed_dim": int(conv.shape[0]),
    }
    depth = 0
    while f"layer.{depth}.norm1.weight" in sd:
        depth += 1
    cfg["depth"] = depth
    if "layer.0.mlp.gate_proj.weight" in sd:
        cfg["ffn_layer"] = "swiglu"
        cfg["ffn_hidden"] = int(
            np.asarray(sd["layer.0.mlp.gate_proj.weight"]).shape[0])
    else:
        cfg["ffn_layer"] = "mlp"
        cfg["ffn_hidden"] = int(
            np.asarray(sd["layer.0.mlp.up_proj.weight"]).shape[0])
    return cfg


def convert_hf_dinov3(sd, depth: int, num_heads: Optional[int] = None) -> dict:
    """HuggingFace `DINOv3ViTModel` state dict -> the flat
    VisionTransformer dict of an encoder built with `use_pos_embed=False,
    use_rope_2d=True, rope_normalized=True` (no learned pos-embed; q / k
    features permuted by `_interleave_heads`; the absent k bias a zero
    segment of the fused qkv bias; the gated MLP's gate / up as `w12`, gate
    first, down as `w3`; the plain MLP's up / down as `fc1` / `fc2`;
    `mask_token` dropped). `num_heads` defaults to width / 64."""
    def g(key):
        return np.asarray(sd[key])

    e = g("embeddings.cls_token").shape[-1]
    if num_heads is None:
        num_heads = e // 64
    params = {
        "cls_token": g("embeddings.cls_token"),
        "register_tokens": g("embeddings.register_tokens"),
        "patch_embed": {"proj": {
            "kernel": _conv(g("embeddings.patch_embeddings.weight")),
            "bias": g("embeddings.patch_embeddings.bias")}},
        "norm": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    for i in range(depth):
        p = f"layer.{i}"
        a = f"{p}.attention"
        v_w = g(f"{a}.v_proj.weight")

        def bias(name):
            key = f"{a}.{name}.bias"
            return g(key) if key in sd else np.zeros(e, v_w.dtype)

        q_w = _interleave_heads(g(f"{a}.q_proj.weight"), num_heads)
        k_w = _interleave_heads(g(f"{a}.k_proj.weight"), num_heads)
        q_b = _interleave_heads(bias("q_proj")[:, None], num_heads)[:, 0]
        k_b = _interleave_heads(bias("k_proj")[:, None], num_heads)[:, 0]
        blk = {
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "attn": {
                "qkv": {"kernel": np.concatenate([q_w, k_w, v_w], 0).T,
                        "bias": np.concatenate([q_b, k_b, bias("v_proj")],
                                               0)},
                "proj": _dense(sd, f"{a}.o_proj"),
            },
            "ls1": {"gamma": g(f"{p}.layer_scale1.lambda1")},
            "ls2": {"gamma": g(f"{p}.layer_scale2.lambda1")},
        }
        if f"{p}.mlp.gate_proj.weight" in sd:  # gated MLP (SwiGLU)
            w12 = np.concatenate([g(f"{p}.mlp.gate_proj.weight"),
                                  g(f"{p}.mlp.up_proj.weight")], axis=0)
            b12 = np.concatenate([g(f"{p}.mlp.gate_proj.bias"),
                                  g(f"{p}.mlp.up_proj.bias")], axis=0)
            blk["mlp"] = {"w12": {"kernel": w12.T, "bias": b12},
                          "w3": _dense(sd, f"{p}.mlp.down_proj")}
        else:
            blk["mlp"] = {"fc1": _dense(sd, f"{p}.mlp.up_proj"),
                          "fc2": _dense(sd, f"{p}.mlp.down_proj")}
        params[f"blocks_{i}"] = blk
    return _flat(params)


def _convert_fusion_layer(sd, p: str) -> dict:
    """One torch `TransformerEncoderLayer` (reference
    `transformer_blocks.py:447-587`) -> the fusion layer's nested dict."""
    return {
        "self_attn": {
            "in_proj": {"kernel": _t(sd[f"{p}.self_attn.in_proj_weight"]),
                        "bias": np.asarray(sd[f"{p}.self_attn.in_proj_bias"])},
            "out_proj": _dense(sd, f"{p}.self_attn.out_proj"),
        },
        "linear1": _dense(sd, f"{p}.linear1"),
        "linear2": _dense(sd, f"{p}.linear2"),
        "norm1": _ln(sd, f"{p}.norm1"),
        "norm2": _ln(sd, f"{p}.norm2"),
    }


def convert_reference_mst(sd, depth: int = 12, fusion_layers: int = 1) -> dict:
    """Reference `DinoV2ClassifierSlice` state dict -> the flat dict of the
    whole `DinoSliceClassifier` (encoder, slice fusion, CLS, head, and the
    bottleneck / slice position table where present). A transformer-fusion
    checkpoint with fewer layers than `fusion_layers` raises KeyError."""
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    params = {f"encoder/{k}": v
              for k, v in convert_dinov2_vit(enc_sd, depth).items()}
    tree = {}
    if "cls_token" in sd:  # transformer fusion only (`dino.py:97`)
        tree["cls_token"] = np.asarray(sd["cls_token"])
    tree["head"] = _dense(sd, "linear")
    if "bottleneck.weight" in sd:
        tree["bottleneck"] = _dense(sd, "bottleneck")
    if "slice_pos_emb.weight" in sd:
        tree["slice_pos_emb"] = {
            "embedding": np.asarray(sd["slice_pos_emb.weight"])}
    for i in range(fusion_layers):
        if f"slice_fusion.layers.{i}.self_attn.in_proj_weight" not in sd:
            if i == 0:
                break  # linear / average fusion: no transformer layers
            raise KeyError(
                f"checkpoint has only {i} slice_fusion layer(s) but "
                f"fusion_layers={fusion_layers} was requested")
        tree[f"fusion_{i}"] = _convert_fusion_layer(
            sd, f"slice_fusion.layers.{i}")
    if "slice_fusion.norm.weight" in sd:
        tree["fusion_norm"] = _ln(sd, "slice_fusion.norm")
    params.update(_flat(tree))
    return params


def fold_linear_fusion(params: Mapping[str, np.ndarray]) -> dict:
    """A flat dict of an older mst_tpu `slice_fusion="linear"` checkpoint
    (an extra `fusion_linear` Dense(D*e -> e) before the head) in the
    current layout, the head reading the flat D*e vector itself
    (`dino.py:99,156`): with no nonlinearity between the two products the
    fold is exact algebra, head(fl(x)) = x @ (W_fl @ W_head) + (b_fl @
    W_head + b_head), in f32 numpy as `mst_tpu`'s `fold_linear_fusion`.
    A dict without `fusion_linear` comes back as it is."""
    if "fusion_linear/kernel" not in params:
        return dict(params)
    out = {k: v for k, v in params.items()
           if not k.startswith("fusion_linear/")}
    w_fl = np.asarray(params["fusion_linear/kernel"], np.float32)
    b_fl = np.asarray(params["fusion_linear/bias"], np.float32)
    w_h = np.asarray(params["head/kernel"], np.float32)
    b_h = np.asarray(params["head/bias"], np.float32)
    out["head/kernel"] = w_fl @ w_h
    out["head/bias"] = b_fl @ w_h + b_h
    return out


def _bn(sd, prefix) -> tuple:
    """A torch BatchNorm -> ({scale, bias}, {mean, var})."""
    return ({"scale": np.asarray(sd[f"{prefix}.weight"]),
             "bias": np.asarray(sd[f"{prefix}.bias"])},
            {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])})


def convert_torch_resnet(sd, variant: int) -> tuple:
    """A torchvision or MONAI / MedicalNet resnet{18,34,50,...} state dict
    -> (params, batch_stats) of `ResNetBackbone`, flat and `/`-keyed from
    the backbone down (`conv1/kernel`, `layer1_0/bn1/scale`, ...). MONAI's
    ResNet uses torchvision's module names (conv1 / bn1 / layerX.i.convN /
    bnN / downsample.0 / .1) with 5-D kernels (`_conv` transposes any
    rank); MedicalNet's DataParallel `module.` prefix is stripped."""
    from mst_tpu_torch.models.resnet import _RESNET_LAYERS, Bottleneck

    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()
              if k.startswith("module.")}
    block_cls, counts = _RESNET_LAYERS[variant]
    n_conv = 3 if block_cls is Bottleneck else 2
    params = {"conv1": {"kernel": _conv(sd["conv1.weight"])}}
    stats = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for stage, n in enumerate(counts):
        for i in range(n):
            tp, op = f"layer{stage + 1}.{i}", f"layer{stage + 1}_{i}"
            blk_p, blk_s = {}, {}
            for j in range(1, n_conv + 1):
                blk_p[f"conv{j}"] = {
                    "kernel": _conv(sd[f"{tp}.conv{j}.weight"])}
                blk_p[f"bn{j}"], blk_s[f"bn{j}"] = _bn(sd, f"{tp}.bn{j}")
            if f"{tp}.downsample.0.weight" in sd:
                blk_p["downsample_conv"] = {
                    "kernel": _conv(sd[f"{tp}.downsample.0.weight"])}
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(
                    sd, f"{tp}.downsample.1")
            params[op], stats[op] = blk_p, blk_s
    return _flat(params), _flat(stats)


def _prefixed(prefix: str, flat: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in flat.items()}


def convert_reference_resnet3d(sd, variant: int = 18) -> tuple:
    """The reference's 3D `ResNet` state dict (MONAI `nets.resnet{N}(...,
    spatial_dims=3)` under `model.`, `mst/models/resnet.py:51-53`) ->
    (params, batch_stats) of `ResNet3DClassifier`, flat: the backbone and
    the `fc` head."""
    bb_sd = {k[len("model."):]: v for k, v in sd.items()
             if k.startswith("model.")}
    fc_w, fc_b = bb_sd.pop("fc.weight"), bb_sd.pop("fc.bias")
    bb_params, bb_stats = convert_torch_resnet(bb_sd, variant)
    params = _prefixed("backbone", bb_params)
    params.update({"fc/kernel": _t(fc_w), "fc/bias": np.asarray(fc_b)})
    return params, _prefixed("backbone", bb_stats)


def convert_reference_resnet_slice(sd, variant: int = 34,
                                   fusion_layers: int = 1) -> tuple:
    """The reference's `ResNetSliceTrans` state dict (the 2D torchvision
    backbone under `model.`, `mst/models/resnet.py:127-244`) -> (params,
    batch_stats) of `ResNetSliceTrans`, flat: backbone, slice fusion, CLS,
    fusion norm and head."""
    bb_sd = {k[len("model."):]: v for k, v in sd.items()
             if k.startswith("model.")}
    bb_params, bb_stats = convert_torch_resnet(bb_sd, variant)
    tree = {"cls_token": np.asarray(sd["cls_token"]),
            "linear": _dense(sd, "linear"),
            "fusion_norm": _ln(sd, "slice_fusion.norm")}
    for i in range(fusion_layers):
        tree[f"fusion_{i}"] = _convert_fusion_layer(
            sd, f"slice_fusion.layers.{i}")
    params = _prefixed("backbone", bb_params)
    params.update(_flat(tree))
    return params, _prefixed("backbone", bb_stats)


def load_torch_state_dict(path) -> dict:
    """A .pth / .pt checkpoint as a numpy state dict (on the CPU): a state
    dict, a dict holding one under "state_dict", or a pickled module."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items()}


def load_pretrained_encoder(params: Mapping[str, np.ndarray], state_dict,
                            depth: int, ffn_layer: str = "mlp",
                            num_heads: Optional[int] = None) -> dict:
    """`params` (a model's flat dict) with its `encoder/` keys replaced by
    the converted DINOv2 / DINOv3 state dict (any layout of
    `detect_encoder_layout`; the reference's `load_pretrained`,
    `base_model.py:67-75`)."""
    out = {k: v for k, v in params.items() if not k.startswith("encoder/")}
    out.update({f"encoder/{k}": v for k, v in convert_any_dinov2(
        state_dict, depth, ffn_layer, num_heads).items()})
    return out
