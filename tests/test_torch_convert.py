"""The port's pretrained state-dict converters (`mst_tpu_torch.models.
convert`) against `mst_tpu.models.convert` on seeded synthetic state dicts:

- each converter (torch.hub DINOv2 with an MLP, a SwiGLU and the chunked
  block layout; HF Dinov2; HF DINOv3 plain and gated; the reference's whole
  MST with and without bottleneck / slice position table, and its
  truncated-fusion KeyError): the port's flat dict equals the JAX tree
  flattened with "/", key for key and bit for bit;
- the config inference (`pos_embed_grid_from_sd`, `detect_encoder_layout`,
  `dinov3_config_from_sd`): equal;
- a tiny model built from the inferred config and loaded through the port
  (`load_pretrained_encoder`) against flax on the JAX-converted tree:
  logits within 1e-4 in f32;
- `--pretrained_path --freeze` through the train CLI on the CPU (as
  `tests/test_train_e2e.py:210`): the encoder leaves training equal to
  the converted values bit for bit, and the hparams record the grid.

No test needs `transformers` or downloaded weights."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from mst_tpu.models import convert as jconv
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.mst import dino_v3_classifier_slice as jax_dinov3
from mst_tpu_torch.models import convert as tconv
from mst_tpu_torch.models.vit_fast import fused_mst_logits
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.utils.checkpoint import load_best_params, load_hparams

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_fused_block.py:452


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _same(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def _hub_sd(rng, embed=32, depth=2, grid=16, patch=14, ffn="mlp",
            registers=0, chunked=False):
    """A random torch.hub-layout DINOv2 ViT state dict (the generator of
    tests/test_train_e2e.py:177, with SwiGLU, registers and the chunked
    `blocks.0.{i}` layout)."""
    sd = {
        "cls_token": rng.normal(size=(1, 1, embed)),
        "pos_embed": rng.normal(size=(1, grid * grid + 1, embed)),
        "mask_token": rng.normal(size=(1, embed)),
        "patch_embed.proj.weight": rng.normal(size=(embed, 3, patch, patch)),
        "patch_embed.proj.bias": rng.normal(size=(embed,)),
        "norm.weight": rng.normal(size=(embed,)),
        "norm.bias": rng.normal(size=(embed,)),
    }
    if registers:
        sd["register_tokens"] = rng.normal(size=(1, registers, embed))
    for i in range(depth):
        p = f"blocks.0.{i}" if chunked else f"blocks.{i}"
        sd.update({
            f"{p}.norm1.weight": rng.normal(size=(embed,)),
            f"{p}.norm1.bias": rng.normal(size=(embed,)),
            f"{p}.attn.qkv.weight": rng.normal(size=(3 * embed, embed)),
            f"{p}.attn.qkv.bias": rng.normal(size=(3 * embed,)),
            f"{p}.attn.proj.weight": rng.normal(size=(embed, embed)),
            f"{p}.attn.proj.bias": rng.normal(size=(embed,)),
            f"{p}.ls1.gamma": rng.normal(size=(embed,)),
            f"{p}.ls2.gamma": rng.normal(size=(embed,)),
            f"{p}.norm2.weight": rng.normal(size=(embed,)),
            f"{p}.norm2.bias": rng.normal(size=(embed,)),
        })
        if ffn == "swiglu":
            hidden = 64
            sd.update({
                f"{p}.mlp.w12.weight": rng.normal(size=(2 * hidden, embed)),
                f"{p}.mlp.w12.bias": rng.normal(size=(2 * hidden,)),
                f"{p}.mlp.w3.weight": rng.normal(size=(embed, hidden)),
                f"{p}.mlp.w3.bias": rng.normal(size=(embed,)),
            })
        else:
            sd.update({
                f"{p}.mlp.fc1.weight": rng.normal(size=(4 * embed, embed)),
                f"{p}.mlp.fc1.bias": rng.normal(size=(4 * embed,)),
                f"{p}.mlp.fc2.weight": rng.normal(size=(embed, 4 * embed)),
                f"{p}.mlp.fc2.bias": rng.normal(size=(embed,)),
            })
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _hf_v2_sd(rng, embed=32, depth=2, grid=4, patch=14, swiglu=False):
    """A random HuggingFace Dinov2Model state dict (2 registers)."""
    sd = {
        "embeddings.cls_token": rng.normal(size=(1, 1, embed)),
        "embeddings.mask_token": rng.normal(size=(1, embed)),
        "embeddings.register_tokens": rng.normal(size=(1, 2, embed)),
        "embeddings.position_embeddings": rng.normal(
            size=(1, grid * grid + 1, embed)),
        "embeddings.patch_embeddings.projection.weight": rng.normal(
            size=(embed, 3, patch, patch)),
        "embeddings.patch_embeddings.projection.bias": rng.normal(
            size=(embed,)),
        "layernorm.weight": rng.normal(size=(embed,)),
        "layernorm.bias": rng.normal(size=(embed,)),
    }
    for i in range(depth):
        p = f"encoder.layer.{i}"
        a = f"{p}.attention.attention"
        for n in ("query", "key", "value"):
            sd[f"{a}.{n}.weight"] = rng.normal(size=(embed, embed))
            sd[f"{a}.{n}.bias"] = rng.normal(size=(embed,))
        sd.update({
            f"{p}.attention.output.dense.weight": rng.normal(
                size=(embed, embed)),
            f"{p}.attention.output.dense.bias": rng.normal(size=(embed,)),
            f"{p}.norm1.weight": rng.normal(size=(embed,)),
            f"{p}.norm1.bias": rng.normal(size=(embed,)),
            f"{p}.norm2.weight": rng.normal(size=(embed,)),
            f"{p}.norm2.bias": rng.normal(size=(embed,)),
            f"{p}.layer_scale1.lambda1": rng.normal(size=(embed,)),
            f"{p}.layer_scale2.lambda1": rng.normal(size=(embed,)),
        })
        if swiglu:
            sd.update({
                f"{p}.mlp.weights_in.weight": rng.normal(size=(128, embed)),
                f"{p}.mlp.weights_in.bias": rng.normal(size=(128,)),
                f"{p}.mlp.weights_out.weight": rng.normal(size=(embed, 64)),
                f"{p}.mlp.weights_out.bias": rng.normal(size=(embed,)),
            })
        else:
            sd.update({
                f"{p}.mlp.fc1.weight": rng.normal(size=(4 * embed, embed)),
                f"{p}.mlp.fc1.bias": rng.normal(size=(4 * embed,)),
                f"{p}.mlp.fc2.weight": rng.normal(size=(embed, 4 * embed)),
                f"{p}.mlp.fc2.bias": rng.normal(size=(embed,)),
            })
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _hf_v3_sd(rng, embed=32, depth=2, patch=16, registers=2, gated=False,
              hidden=None):
    """A random HuggingFace DINOv3ViTModel state dict: no pos-embed, no k
    bias, LayerScale, a plain (up / down) or gated (gate / up / down)
    MLP."""
    hidden = hidden or 4 * embed
    sd = {
        "embeddings.cls_token": rng.normal(size=(1, 1, embed)),
        "embeddings.mask_token": rng.normal(size=(1, 1, embed)),
        "embeddings.register_tokens": rng.normal(size=(1, registers, embed)),
        "embeddings.patch_embeddings.weight": rng.normal(
            size=(embed, 3, patch, patch)),
        "embeddings.patch_embeddings.bias": rng.normal(size=(embed,)),
        "norm.weight": rng.normal(size=(embed,)),
        "norm.bias": rng.normal(size=(embed,)),
    }
    for i in range(depth):
        p = f"layer.{i}"
        a = f"{p}.attention"
        sd.update({
            f"{a}.q_proj.weight": rng.normal(size=(embed, embed)),
            f"{a}.q_proj.bias": rng.normal(size=(embed,)),
            f"{a}.k_proj.weight": rng.normal(size=(embed, embed)),
            f"{a}.v_proj.weight": rng.normal(size=(embed, embed)),
            f"{a}.v_proj.bias": rng.normal(size=(embed,)),
            f"{a}.o_proj.weight": rng.normal(size=(embed, embed)),
            f"{a}.o_proj.bias": rng.normal(size=(embed,)),
            f"{p}.norm1.weight": rng.normal(size=(embed,)),
            f"{p}.norm1.bias": rng.normal(size=(embed,)),
            f"{p}.norm2.weight": rng.normal(size=(embed,)),
            f"{p}.norm2.bias": rng.normal(size=(embed,)),
            f"{p}.layer_scale1.lambda1": rng.normal(size=(embed,)),
            f"{p}.layer_scale2.lambda1": rng.normal(size=(embed,)),
            f"{p}.mlp.up_proj.weight": rng.normal(size=(hidden, embed)),
            f"{p}.mlp.up_proj.bias": rng.normal(size=(hidden,)),
            f"{p}.mlp.down_proj.weight": rng.normal(size=(embed, hidden)),
            f"{p}.mlp.down_proj.bias": rng.normal(size=(embed,)),
        })
        if gated:
            sd[f"{p}.mlp.gate_proj.weight"] = rng.normal(size=(hidden, embed))
            sd[f"{p}.mlp.gate_proj.bias"] = rng.normal(size=(hidden,))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _reference_mst_sd(rng, bottleneck=False, slice_pos=False, layers=1):
    """A random reference `DinoV2ClassifierSlice` state dict."""
    sd = {f"encoder.{k}": v for k, v in _hub_sd(rng).items()}
    emb = 8 if bottleneck else 32
    if bottleneck:
        sd["bottleneck.weight"] = rng.normal(size=(emb, 32))
        sd["bottleneck.bias"] = rng.normal(size=(emb,))
    if slice_pos:
        sd["slice_pos_emb.weight"] = rng.normal(size=(256, emb))
    sd["cls_token"] = rng.normal(size=(1, 1, emb))
    sd["linear.weight"] = rng.normal(size=(2, emb))
    sd["linear.bias"] = rng.normal(size=(2,))
    for i in range(layers):
        p = f"slice_fusion.layers.{i}"
        sd.update({
            f"{p}.self_attn.in_proj_weight": rng.normal(size=(3 * emb, emb)),
            f"{p}.self_attn.in_proj_bias": rng.normal(size=(3 * emb,)),
            f"{p}.self_attn.out_proj.weight": rng.normal(size=(emb, emb)),
            f"{p}.self_attn.out_proj.bias": rng.normal(size=(emb,)),
            f"{p}.linear1.weight": rng.normal(size=(emb, emb)),
            f"{p}.linear1.bias": rng.normal(size=(emb,)),
            f"{p}.linear2.weight": rng.normal(size=(emb, emb)),
            f"{p}.linear2.bias": rng.normal(size=(emb,)),
            f"{p}.norm1.weight": rng.normal(size=(emb,)),
            f"{p}.norm1.bias": rng.normal(size=(emb,)),
            f"{p}.norm2.weight": rng.normal(size=(emb,)),
            f"{p}.norm2.bias": rng.normal(size=(emb,)),
        })
    sd["slice_fusion.norm.weight"] = rng.normal(size=(emb,))
    sd["slice_fusion.norm.bias"] = rng.normal(size=(emb,))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


# -- the converters, flat dict against the flattened JAX tree --------------

@pytest.mark.parametrize("ffn,chunked,registers", [("mlp", False, 0),
                                                   ("swiglu", False, 4),
                                                   ("mlp", True, 0)])
def test_hub_dinov2_matches_mst_tpu(ffn, chunked, registers):
    sd = _hub_sd(np.random.default_rng(0), ffn=ffn, chunked=chunked,
                 registers=registers)
    _same(tconv.convert_dinov2_vit(sd, 2, ffn),
          _flat(jconv.convert_dinov2_vit(sd, 2, ffn)))
    _same(tconv.convert_any_dinov2(sd, 2, ffn),
          _flat(jconv.convert_any_dinov2(sd, 2, ffn)))


@pytest.mark.parametrize("swiglu", [False, True])
def test_hf_dinov2_matches_mst_tpu(swiglu):
    sd = _hf_v2_sd(np.random.default_rng(1), swiglu=swiglu)
    _same(tconv.convert_hf_dinov2(sd, 2), _flat(jconv.convert_hf_dinov2(sd, 2)))
    _same(tconv.convert_any_dinov2(sd, 2),
          _flat(jconv.convert_any_dinov2(sd, 2)))


@pytest.mark.parametrize("gated", [False, True])
def test_hf_dinov3_matches_mst_tpu(gated):
    """At E = 128 (two heads of 64, the default head count) and at E = 32
    with the head count given."""
    sd = _hf_v3_sd(np.random.default_rng(2), embed=128, gated=gated,
                   hidden=96 if gated else None)
    _same(tconv.convert_hf_dinov3(sd, 2), _flat(jconv.convert_hf_dinov3(sd, 2)))
    _same(tconv.convert_any_dinov2(sd, 2),
          _flat(jconv.convert_any_dinov2(sd, 2)))
    sd = _hf_v3_sd(np.random.default_rng(3), gated=gated)
    _same(tconv.convert_hf_dinov3(sd, 2, num_heads=2),
          _flat(jconv.convert_hf_dinov3(sd, 2, num_heads=2)))


@pytest.mark.parametrize("bottleneck,slice_pos", [(False, False),
                                                  (True, True)])
def test_reference_mst_matches_mst_tpu(bottleneck, slice_pos):
    sd = _reference_mst_sd(np.random.default_rng(4), bottleneck, slice_pos)
    _same(tconv.convert_reference_mst(sd, depth=2),
          _flat(jconv.convert_reference_mst(sd, depth=2)))


def test_reference_mst_truncated_fusion_raises():
    sd = _reference_mst_sd(np.random.default_rng(5), layers=1)
    with pytest.raises(KeyError, match="only 1 slice_fusion layer"):
        jconv.convert_reference_mst(sd, depth=2, fusion_layers=2)
    with pytest.raises(KeyError, match="only 1 slice_fusion layer"):
        tconv.convert_reference_mst(sd, depth=2, fusion_layers=2)


# -- config inference ----------------------------------------------------

def test_config_inference_matches_mst_tpu():
    rng = np.random.default_rng(6)
    hub, hf = _hub_sd(rng, grid=37), _hf_v2_sd(rng, grid=16)
    v3, v3g = _hf_v3_sd(rng), _hf_v3_sd(rng, gated=True, hidden=48)
    for sd in (hub, hf):
        assert tconv.pos_embed_grid_from_sd(sd) == \
            jconv.pos_embed_grid_from_sd(sd)
    assert tconv.pos_embed_grid_from_sd(hub) == 37
    for sd, want in ((hub, "hub"), (hf, "hf"), (v3, "hf_v3")):
        assert tconv.detect_encoder_layout(sd) == want == \
            jconv.detect_encoder_layout(sd)
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="unrecognised"):
            mod.detect_encoder_layout({"foo": np.zeros(1)})
    for sd in (v3, v3g):
        assert tconv.dinov3_config_from_sd(sd) == \
            jconv.dinov3_config_from_sd(sd)
    assert tconv.dinov3_config_from_sd(v3g)["ffn_layer"] == "swiglu"


# -- models built from the inferred config ---------------------------------

def _logits_pair(sd, jax_model, port_args, x):
    """(flax logits on the JAX-converted encoder, port logits on the port's
    `load_pretrained_encoder`), the other parameters from the flax init."""
    params = jax_model.init(jax.random.PRNGKey(0),
                            jnp.asarray(x[:, :, :2]))["params"]
    flat = _flat(params)
    jtree = dict(params)  # depth 2, 2 heads: the tiny size
    if tconv.detect_encoder_layout(sd) == "hf_v3":
        jtree["encoder"] = jconv.convert_hf_dinov3(sd, 2, num_heads=2)
    else:
        jtree["encoder"] = jconv.convert_any_dinov2(sd, 2)
    ref = np.asarray(jax_model.apply({"params": jtree}, jnp.asarray(x)))
    model = get_model(port_args.model, model_size="tiny", fusion_heads=4,
                      **cli.model_kwargs(port_args, sd))
    tconv.params_from_flax(model, tconv.load_pretrained_encoder(
        flat, sd, model.encoder.depth, model.ffn_layer,
        model.encoder.num_heads))
    with torch.no_grad():
        ours = fused_mst_logits(model, torch.from_numpy(x)).numpy()
    return ours, ref, model


def test_hub_pretrained_model_matches_flax():
    """A hub state dict with a 4 x 4 grid and 2 registers: the port's model
    takes both from the file (`cli.pretrained_kwargs`)."""
    sd = _hub_sd(np.random.default_rng(7), grid=4, registers=2)
    x = np.random.default_rng(8).standard_normal((2, 1, 3, 28, 28)).astype(
        np.float32)
    jm = JaxMST(out_ch=2, model_size="tiny", patch_size=14, fusion_heads=4,
                pos_embed_grid=4, num_register_tokens=2, use_flash=False)
    args = cli.parse_args(["--dataset", "Synthetic"])
    ours, ref, model = _logits_pair(sd, jm, args, x)
    assert model.config["pos_embed_grid"] == 4
    assert model.config["num_register_tokens"] == 2
    np.testing.assert_allclose(ours, ref, **MODEL_TOL)


@pytest.mark.parametrize("gated", [False, True])
def test_hf_dinov3_pretrained_model_matches_flax(gated):
    """An HF DINOv3 state dict (patch 16, 2 registers, no pos-embed; plain
    or gated FFN of width 96) through `--model DinoV3ClassifierSlice`."""
    sd = _hf_v3_sd(np.random.default_rng(9), gated=gated, hidden=96)
    x = np.random.default_rng(10).standard_normal((2, 1, 3, 32, 32)).astype(
        np.float32)
    cfg = jconv.dinov3_config_from_sd(sd)
    jm = jax_dinov3(out_ch=2, model_size="tiny", fusion_heads=4,
                    num_register_tokens=cfg["num_register_tokens"],
                    ffn_layer=cfg["ffn_layer"], ffn_hidden=cfg["ffn_hidden"],
                    use_flash=False)
    args = cli.parse_args(["--dataset", "Synthetic", "--model",
                           "DinoV3ClassifierSlice"])
    ours, ref, model = _logits_pair(sd, jm, args, x)
    assert model.config["ffn_layer"] == cfg["ffn_layer"]
    assert model.config["use_pos_embed"] is False
    np.testing.assert_allclose(ours, ref, **MODEL_TOL)


# -- the train CLI ---------------------------------------------------------

def test_train_cli_pretrained_freeze_keeps_the_encoder(tmp_path):
    """`--pretrained_path FILE --freeze` on the CPU: one epoch, then the
    best checkpoint's encoder is the converted state dict bit for bit, and
    the hparams record the grid that `serve` / `predict` rebuild."""
    sd = _hub_sd(np.random.default_rng(11))
    pth = tmp_path / "encoder.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    run_dir, _ = cli.main(
        ["--dataset", "Synthetic", "--model_size", "tiny", "--fusion_heads",
         "4", "--dtype", "float32", "--max_epochs", "1", "--batch_size", "4",
         "--num_train_samples", "8", "--lr", "1e-3", "--run_dir",
         str(tmp_path / "runs"), "--pretrained_path", str(pth), "--freeze"],
        device="cpu", shape_cdhw=(1, 2, 28, 28), num_samples=8)
    got = {k[len("encoder/"):]: v for k, v in load_best_params(run_dir).items()
           if k.startswith("encoder/")}
    want = {k: v.astype(np.float32) for k, v in
            _flat(jconv.convert_dinov2_vit(sd, 2)).items()}
    _same(got, want)
    hp = load_hparams(run_dir)
    assert hp["pos_embed_grid"] == 16 and hp["freeze"] is True
    last = json.loads((run_dir / "last.meta.json").read_text())
    assert last["epoch"] == 0
