"""The port's W8A8 int8 serving path on CPU tensors against `mst_tpu`, in f32
on the same numpy inputs:

- `quantize_weight_int8`, `_quant_rows` / `_quant_static` (exact .5 ties
  included) and the exact integer product bit for bit;
- the three int8 sub-layers, dynamic and static, in every flag form (CLS
  row, rollout carry, Abnar factor, RoPE), against the Pallas kernels in
  interpret mode on the same int8 codes;
- `quantize_mst_int8` (with `_fold_static_scales`) leaf by leaf and
  `calibrate_act_scales_int8` against the JAX tree functions;
- tiny models quantized by `mst_tpu` and carried across
  (`quantized_from_flax`): logits and all three saliency modes against
  `mst_tpu`'s `fused_mst_logits` / `fused_mst_saliency`; the JAX suite's bar
  (probs within 0.05, argmax) of the port's own int8 path against its full
  precision one for DINOv2, DINOv3 and a SwiGLU `tiny128`;
- `predict --int8 [--int8_calib N]` and `serve --int8` on a tiny run folder.

On the CPU every kernel wrapper takes its plain version, so these tests pin
the plain versions the CUDA kernels are checked against on the card
(`chip_smoke.py` phases 31-33). The sub-layer and model limits are 1e-4 of
the largest magnitude: a code can flip by one where the two frameworks' LN
or GELU, summed in another order, land on the other side of a .5 tie."""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.mst import dino_v3_classifier_slice as jax_dinov3
from mst_tpu.models.vit_fast import FastViTConfig as JaxFastViTConfig
from mst_tpu.models.vit_fast import fused_mst_logits as jax_fused_mst_logits
from mst_tpu.models.vit_fast import fused_mst_saliency as jax_fused_saliency
from mst_tpu.ops import fused_int8 as jq
from mst_tpu_torch import predict, serve
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D
from mst_tpu_torch.models.convert import (
    params_from_flax,
    quantized_from_flax,
    random_flax_params,
)
from mst_tpu_torch.models.layers import QDense
from mst_tpu_torch.models.mst import (
    DinoSliceClassifier,
    dino_v3_classifier_slice,
)
from mst_tpu_torch.models.vit_fast import (
    FastViTConfig,
    fused_mst_logits,
    fused_mst_saliency,
    fused_vit_cls,
)
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tq
from mst_tpu_torch.ops.rotary import rope_tables
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.train.trainer import Trainer
from mst_tpu_torch.utils.checkpoint import BEST_POINTER

REL = 1e-4  # of the largest magnitude (module docstring)
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
V3 = dict(model_size="tiny", patch_size=14, fusion_heads=4,
          num_register_tokens=2)
GATED = dict(model_size="tiny128", ffn_layer="swiglu", patch_size=14,
             fusion_heads=4)
MODES = ("last", "rollout", "rollout_abnar")
N, GRID, E, HEADS = 2, (2, 4), 64, 4
S = 1 + GRID[0] * GRID[1]


def _no_launches():
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch
    assert set(tfb.sublayer_calls().values()) == {0}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close_rel(ours, ref, rel=REL, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


# -- quantization, bit for bit ------------------------------------------------


def test_quantize_weight_matches_mst_tpu_bit_for_bit():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 5] = 0.0  # a zero column: the 1e-12 floor of the scale
    w[:, 7] *= 1e3
    q, s = tq.quantize_weight_int8(_t(w))
    jqw, js = jq.quantize_weight_int8(jnp.asarray(w))
    assert q.dtype == torch.int8 and tuple(s.shape) == (1, 96)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 5]) == np.float32(1e-12) and not q[:, 5].any()


def test_quant_rows_and_static_match_mst_tpu_with_ties():
    rng = np.random.default_rng(1)
    h = (rng.standard_normal((16, 96)) * rng.uniform(0.01, 50, (16, 1))
         ).astype(np.float32)
    h[3] = 0.0  # a zero row: the 1e-12 floor
    # exact .5 ties (round half to even) and values past the clip
    h[4, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -200.0]
    q, sc = tq._quant_rows(_t(h))
    jqr, jsc = jq._quant_rows(jnp.asarray(h))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqr))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc)[:, 0])
    qs = tq._quant_static(_t(h))
    np.testing.assert_array_equal(qs.numpy(),
                                  np.asarray(jq._quant_static(jnp.asarray(h))))
    assert qs[4, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -127]
    # the wrapper takes the plain version on the CPU, bf16 o included
    tfb.reset_launch_counts()
    for v in (_t(h), _t(h).to(torch.bfloat16)):
        qw, sw = tq.quant_rows(v)
        want = jq._quant_rows(jnp.asarray(v.float().numpy()))
        np.testing.assert_array_equal(qw.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(tq.quant_rows(v, True).numpy(),
                                      tq._quant_static(v.float()).numpy())
    _no_launches()


def test_exact_integer_product_at_k4096():
    """K = 4096 products of +-127 codes reach 66 M, past 2^24: the plain
    product is exact (f64), and f32(acc) equals the JAX int32 -> f32."""
    rng = np.random.default_rng(2)
    a = (rng.choice([-127, 127], (8, 4096))).astype(np.int8)
    w = (rng.choice([-127, 127], (4096, 16))).astype(np.int8)
    a[0] = 127
    w[:, 0] = 127  # the largest sum, 4096 * 127^2
    exact = a.astype(np.int64) @ w.astype(np.int64)
    acc = tq._dot_i8(_t(a), _t(w))
    assert acc.dtype == torch.float64 and int(acc[0, 0]) == 4096 * 127 ** 2
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), exact)
    jacc = jq._dot_i8(jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_array_equal(acc.float().numpy(),
                                  np.asarray(jacc).astype(np.float32))


# -- the sub-layers against the Pallas kernels (interpret mode) ---------------


def _node(rng, fan_in, fan_out, colmul=1.0, a_inv=None):
    """(QDense, JAX node) holding the same codes; the dequant scale and the
    bias multiplied by `colmul` (a static tree's folding)."""
    w = (rng.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)
         ).astype(np.float32)
    q, s = jq.quantize_weight_int8(jnp.asarray(w))
    s = np.asarray(s) * np.float32(colmul)
    b = (0.1 * rng.standard_normal(fan_out) * colmul).astype(np.float32)
    a = None if a_inv is None else np.full((1, 1), a_inv, np.float32)
    jn = {"q8": q, "scale": jnp.asarray(s), "bias": jnp.asarray(b)}
    if a is not None:
        jn["a_inv"] = jnp.asarray(a)
    return QDense(_t(q), _t(s), _t(b), _t(a)), jn


def _sub_inputs(seed, static, with_ls, ffn=None):
    """x, LN vectors, two (QDense, JAX node) pairs and ls of a sub-layer:
    attention, or `ffn` = (first width, second fan-in). A static one is
    folded as `_fold_static_scales` folds: the LN emits LN(x) * 40 (codes
    range), the first dequant divides by 40; the attention's v-columns
    multiply by 100 (o arrives in codes range) and the proj dequant
    divides by it; the FFN hidden is quantized by a_inv = 30, which the
    second dequant divides out."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, S, E)).astype(np.float32)
    pre = 40.0 if static else 1.0
    ln_s = (pre * (1.0 + 0.1 * rng.standard_normal(E))).astype(np.float32)
    ln_b = (pre * 0.1 * rng.standard_normal(E)).astype(np.float32)
    ls = ((1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
          if with_ls else None)
    if ffn is None:
        colmul = np.ones(3 * E, np.float32) / pre
        if static:
            colmul[2 * E:] *= 100.0
        first = _node(rng, E, 3 * E, colmul)
        second = _node(rng, E, E, 0.01 if static else 1.0)
    else:
        first = _node(rng, E, ffn[0], 1.0 / pre)
        second = _node(rng, ffn[1], E, 1.0 / 30.0 if static else 1.0,
                       a_inv=30.0 if static else None)
    return x, ln_s, ln_b, first, second, ls


ATTN_FORMS = ("plain", "row", "carry", "abnar", "rope", "rope_row",
              "rope_carry", "rope_abnar")


@pytest.mark.parametrize("form", ATTN_FORMS)
@pytest.mark.parametrize("static", [False, True])
def test_attention_sublayer_i8_matches_mst_tpu(form, static):
    x, ln_s, ln_b, (tqkv, jqkv), (tproj, jproj), ls = _sub_inputs(
        ATTN_FORMS.index(form), static, with_ls=form != "row")
    rng = np.random.default_rng(7)
    carry = rng.uniform(0.0, 1.0, (N, HEADS, S)).astype(np.float32)
    kw = {}
    if "row" in form:
        kw["want_row"] = True
    if "carry" in form:
        kw["carry"] = carry
    if "abnar" in form:
        kw["abnar"] = True
    cos = sin = None
    if form.startswith("rope"):
        cos, sin = (u.numpy() for u in rope_tables(GRID, E // HEADS, 1,
                                                   100.0, True, "cpu"))
    tkw = {k: _t(v) if k == "carry" else v for k, v in kw.items()}
    jkw = {k: _j(v) if k == "carry" else v for k, v in kw.items()}
    tfb.reset_launch_counts()
    out = tq.fused_attention_sublayer_i8(
        _t(x), _t(ln_s), _t(ln_b), tqkv, tproj, _t(ls), HEADS, 1e-6,
        rope_cos=_t(cos), rope_sin=_t(sin), static=static, **tkw)
    _no_launches()
    ref = jq.fused_attention_sublayer_i8(
        _j(x), _j(ln_s), _j(ln_b), jqkv, jproj, _j(ls), HEADS, 1e-6,
        rope_cos=_j(cos), rope_sin=_j(sin), static=static, **jkw)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(out) == len(ref) == 1 + len(kw)
    for i, (o, r) in enumerate(zip(out, ref)):
        _close_rel(o.numpy(), r, what=f"{form} output {i}")


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("static", [False, True])
def test_mlp_sublayer_i8_matches_mst_tpu(static, approximate):
    x, ln_s, ln_b, (tfc1, jfc1), (tfc2, jfc2), ls = _sub_inputs(
        10 + approximate, static, True, ffn=(4 * E, 4 * E))
    tfb.reset_launch_counts()
    out = tq.fused_mlp_sublayer_i8(_t(x), _t(ln_s), _t(ln_b), tfc1, tfc2,
                                   _t(ls), approximate)
    _no_launches()
    ref = jq.fused_mlp_sublayer_i8(_j(x), _j(ln_s), _j(ln_b), jfc1, jfc2,
                                   _j(ls), approximate)
    _close_rel(out.numpy(), ref, what="mlp")


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_swiglu_sublayer_i8_matches_mst_tpu(static, with_ls):
    x, ln_s, ln_b, (tw12, jw12), (tw3, jw3), ls = _sub_inputs(
        20 + with_ls, static, with_ls, ffn=(2 * 96, 96))
    tfb.reset_launch_counts()
    out = tq.fused_swiglu_sublayer_i8(_t(x), _t(ln_s), _t(ln_b), tw12, tw3,
                                      _t(ls))
    _no_launches()
    ref = jq.fused_swiglu_sublayer_i8(_j(x), _j(ln_s), _j(ln_b), jw12, jw3,
                                      _j(ls))
    _close_rel(out.numpy(), ref, what="swiglu")
    # the first half alone: the gate g the kernel writes, f32 or codes
    g = tq.ln_gemm_i8_swiglu(_t(x).reshape(-1, E), _t(ln_s), _t(ln_b),
                             tw12.q8, tw12.scale, tw12.bias, 1e-6, static,
                             tw3.a_inv)
    assert g.shape == (N * S, 96)
    assert g.dtype == (torch.int8 if static else torch.float32)


# -- the tree side ------------------------------------------------------------


def _pair(shape, seed=0, v3=False, **kw):
    """(jax model, flat flax params with O(1) LayerScale, port model with
    the same weights, volume)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = (jax_dinov3 if v3 else JaxMST)(out_ch=2, use_flash=False, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2])
                     )["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    build = dino_v3_classifier_slice if v3 else DinoSliceClassifier
    tm = params_from_flax(build(out_ch=2, **kw), flat)
    return jm, flat, tm.eval(), x


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _leaves(model):
    """A quantized port model's parameters and buffers, flax-keyed: its
    state dict, which leaves out each `QDense`'s K-major copy `q8t`
    (`_check_kmajor` holds that to `q8.T`)."""
    return {k.replace(".", "/"): v.detach().numpy()
            for k, v in model.state_dict().items()}


def _check_kmajor(model):
    """Every `QDense` of `model` holds `q8t` = q8.T, contiguous int8 [out,
    in], on q8's device, beside the JAX node's leaves. -> how many."""
    nodes = [m for m in model.modules() if isinstance(m, QDense)]
    for m in nodes:
        assert m.q8t.dtype == torch.int8 and m.q8t.is_contiguous()
        assert m.q8t.device == m.q8.device
        assert tuple(m.q8t.shape) == tuple(m.q8.shape)[::-1]
        assert torch.equal(m.q8t, m.q8.t())
        assert "q8t" not in m.state_dict()
    return len(nodes)


@pytest.mark.parametrize("v3", [False, True])
def test_calibrate_act_scales_matches_mst_tpu(v3):
    kw = V3 if v3 else TINY
    jm, flat, tm, x = _pair((2, 1, 4, 28, 28), seed=3, v3=v3, **kw)
    xs = np.repeat(np.transpose(x, (0, 2, 3, 4, 1)).reshape(8, 28, 28, 1),
                   3, -1)
    ours = tq.calibrate_act_scales_int8(tm.encoder, _t(xs),
                                        FastViTConfig.from_model(tm),
                                        torch.float32, chunk=4)
    ref = jq.calibrate_act_scales_int8(_tree(flat)["encoder"],
                                       jnp.asarray(xs),
                                       JaxFastViTConfig.from_model(jm),
                                       jnp.float32, chunk=4)
    assert ours.keys() == ref.keys() == {"blocks_0", "blocks_1"}
    for name in ref:
        assert ours[name].keys() == ref[name].keys()
        for k in ref[name]:
            np.testing.assert_allclose(ours[name][k], ref[name][k],
                                       rtol=1e-5, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("quantize_last", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_mst_int8_matches_mst_tpu_leaf_by_leaf(static,
                                                        quantize_last):
    jm, flat, tm, x = _pair((2, 1, 3, 28, 28), seed=4, **TINY)
    calib = x if static else None
    qm = tq.quantize_mst_int8(tm, calib, dtype=torch.float32,
                              quantize_last=quantize_last)
    ref = _flat(jq.quantize_mst_params_int8(
        _tree(flat), jm if static else None,
        None if calib is None else jnp.asarray(calib), dtype=jnp.float32,
        quantize_last=quantize_last))
    ours = _leaves(qm)
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        if v.dtype == np.int8 or not static:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:  # folded from calibrated abs-maxima (rtol 1e-5 above)
            np.testing.assert_allclose(ours[k], v, rtol=2e-5, err_msg=k)
    # the K-major copy beside every quantized dense (4 a block: qkv, proj,
    # fc1, fc2)
    assert _check_kmajor(qm) == 4 * (2 if quantize_last else 1)
    if not static:  # the encoder alone, as `mst_tpu` quantizes it
        qenc = tq.quantize_encoder_int8(tm.encoder,
                                        quantize_last=quantize_last)
        enc = _leaves(qenc)
        want = _flat(jq.quantize_encoder_int8(_tree(flat)["encoder"],
                                              quantize_last=quantize_last))
        assert enc.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(enc[k], v, err_msg=k)
        assert _check_kmajor(qenc) == 4 * (2 if quantize_last else 1)
    # the source model is untouched, and the last block's kind
    assert isinstance(tm.encoder.blocks_0.attn.qkv.kernel, torch.nn.Parameter)
    assert isinstance(qm.encoder.blocks_1.attn.qkv, QDense) == quantize_last
    assert (qm.encoder.blocks_0.mlp.fc2.a_inv is not None) == static


def _quantized_pair(shape, seed, static, v3=False, quantize_last=False,
                    **kw):
    """(jax model, JAX quantized tree, port model holding that tree,
    volume): `mst_tpu` quantizes (and calibrates on the volume), the tree
    is carried across."""
    jm, flat, tm, x = _pair(shape, seed=seed, v3=v3, **kw)
    qtree = jq.quantize_mst_params_int8(
        _tree(flat), jm if static else None,
        jnp.asarray(x) if static else None, quantize_last=quantize_last)
    return jm, qtree, quantized_from_flax(tm, _flat(qtree)), x


@pytest.mark.parametrize("quantize_last", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_int8_logits_match_mst_tpu(static, quantize_last):
    jm, qtree, qm, x = _quantized_pair((2, 1, 4, 28, 28), 5, static,
                                       quantize_last=quantize_last, **TINY)
    assert isinstance(qm.encoder.blocks_1.attn.qkv, QDense) == quantize_last
    ref = jax_fused_mst_logits(qtree, jnp.asarray(x), jm, dtype=jnp.float32)
    tfb.reset_launch_counts()
    with torch.no_grad():
        out = fused_mst_logits(qm, _t(x), dtype=torch.float32)
    _no_launches()
    _close_rel(out.numpy(), ref, what="logits")


@pytest.mark.parametrize("plane_mode", MODES)
@pytest.mark.parametrize("static", [False, True])
def test_int8_saliency_matches_mst_tpu(static, plane_mode):
    jm, qtree, qm, x = _quantized_pair((1, 1, 4, 28, 28), 6, static, **TINY)
    ref_p, ref_s = jax_fused_saliency(qtree, jnp.asarray(x), jm,
                                      dtype=jnp.float32,
                                      plane_mode=plane_mode)
    with torch.no_grad():
        p, s = fused_mst_saliency(qm, _t(x), dtype=torch.float32,
                                  plane_mode=plane_mode)
    _close_rel(p.numpy(), ref_p, what="probs")
    _close_rel(s.numpy(), ref_s, what="saliency")


def test_int8_dinov3_logits_match_mst_tpu():
    jm, qtree, qm, x = _quantized_pair((2, 1, 4, 28, 28), 7, True, v3=True,
                                       **V3)
    ref = jax_fused_mst_logits(qtree, jnp.asarray(x), jm, dtype=jnp.float32)
    with torch.no_grad():
        out = fused_mst_logits(qm, _t(x), dtype=torch.float32)
    _close_rel(out.numpy(), ref, what="DINOv3 logits")


@pytest.mark.parametrize("kind", ["dinov2", "dinov3", "swiglu"])
def test_int8_tracks_full_precision(kind):
    """The JAX suite's bar (tests/test_fused_int8.py:91-94): the port's
    int8 path, dynamic and static (calibrated on another batch), within
    0.05 of its own full-precision probs, argmax agreeing."""
    kw, v3 = {"dinov2": (TINY, False), "dinov3": (V3, True),
              "swiglu": (GATED, False)}[kind]
    tm = (dino_v3_classifier_slice if v3 else DinoSliceClassifier)(
        out_ch=2, **kw)
    flat = random_flax_params(tm, 8)
    rng = np.random.default_rng(9)
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(tm, flat).eval()
    x, calib = rng.standard_normal((2, 2, 1, 4, 28, 28)).astype(np.float32)
    with torch.no_grad():
        ref = torch.softmax(fused_mst_logits(tm, _t(x), dtype=torch.float32),
                            -1)
        for c in (None, calib):
            qm = tq.quantize_mst_int8(tm, c)
            p = torch.softmax(fused_mst_logits(qm, _t(x),
                                               dtype=torch.float32), -1)
            np.testing.assert_allclose(p.numpy(), ref.numpy(), atol=0.05)
            assert (p.argmax(-1) == ref.argmax(-1)).all()


def test_int8_blocks_refuse_training():
    _, _, tm, x = _pair((1, 1, 2, 28, 28), seed=10, **TINY)
    qm = tq.quantize_mst_int8(tm)
    cfg = FastViTConfig.from_model(qm)
    xs = torch.ones(2, 28, 28, 3)
    tfb.reset_launch_counts()
    with pytest.raises(ValueError, match="serve only"):
        fused_vit_cls(qm.encoder, xs, cfg, torch.float32, train=True)
    with pytest.raises(ValueError, match="serve only"):
        qm.encoder.blocks_0(torch.ones(2, 5, 32), train=True)
    _no_launches()
    # the CLS row still rides the int8 block, a softmax row per head
    with torch.no_grad():
        _, row = fused_vit_cls(qm.encoder, xs, cfg, torch.float32,
                               want_last_row=True)
    np.testing.assert_allclose(row.sum(-1).numpy(), 1.0, rtol=1e-5)


# -- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """A tiny run folder: `Trainer.fit` for one epoch on Synthetic data."""
    run = tmp_path_factory.mktemp("runs") / "Synthetic" / "DinoV2_run"
    ds = Synthetic_Dataset3D(num_samples=8, shape_cdhw=(1, 2, 28, 28))
    dm = DataModule(ds_train=ds, ds_val=ds, batch_size=4, num_train_samples=8)
    trainer = Trainer(run, max_epochs=1, patience=1)
    state = trainer.init_state(DinoSliceClassifier(out_ch=2, **TINY), 1e-3,
                               seed=0)
    trainer.fit(state, dm, hparams={"model": "DinoV2ClassifierSlice",
                                    "dataset": "Synthetic", **TINY})
    assert (run / BEST_POINTER).exists()
    return run


@pytest.mark.parametrize("calib", [0, 2])
def test_predict_cli_int8(run_folder, tmp_path, calib):
    """`predict --int8 [--int8_calib 2] --use_tta --use_rollout
    --save_saliency`: results.csv from the int8 model, which calibrates on
    the first test volumes as served."""
    out = tmp_path / "out"
    data_kw = dict(shape_cdhw=(1, 2, 28, 28), num_samples=3)
    argv = ["--run_folder", str(run_folder), "--output_dir", str(out),
            "--dtype", "float32", "--int8", "--use_tta", "--use_rollout",
            "--save_saliency"]
    if calib:
        argv += ["--int8_calib", str(calib)]
    args = predict.parse_args(argv)
    assert args.int8 and args.int8_calib == calib
    predict.main(argv, device="cpu", **data_kw)
    with (out / "results.csv").open() as f:
        rows = list(csv.DictReader(f))
    model = serve.load_run_model(run_folder).eval()
    dm = predict.build_datamodule(args, torch.device("cpu"), **data_kw)
    qm = predict.quantize_model(args, model, dm)
    assert isinstance(qm.encoder.blocks_0.attn.qkv, QDense)
    assert (qm.encoder.blocks_0.mlp.fc2.a_inv is not None) == bool(calib)
    fn = make_predict_fn(qm, tta=True, plane_mode="rollout")
    assert len(rows) == 3
    for r, b in zip(rows, dm.test_dataloader()):
        probs, _ = fn(b["source"])
        assert r["uid"] == b["uid"][0]
        np.testing.assert_allclose(float(r["NN_pred"]), float(probs[0, 1]),
                                   rtol=1e-6, atol=1e-7)
        assert (out / f"case_{r['uid']}" / "saliency.nii.gz").exists()
    with pytest.raises(SystemExit):
        predict.parse_args(["--run_folder", "x", "--int8_calib", "2"])


def test_serve_int8(run_folder, capsys):
    """`serve --int8 [--int8_calib N] --run_folder`: the quantized model
    (static: calibrated on the run's val split) answers, and holds the JAX
    suite's bar against the run's full-precision model on the run's test
    split (argmax where that model's probs lie further than 0.05 from the
    class boundary); --int8_calib needs --int8 and a run folder."""
    data_kw = dict(shape_cdhw=(1, 2, 28, 28), num_samples=4)
    vol = np.random.default_rng(11).standard_normal(
        (1, 2, 28, 28)).astype(np.float32)
    test = torch.cat([b["source"] for b in predict.build_datamodule(
        predict.parse_args(["--run_folder", str(run_folder)]),
        torch.device("cpu"), **data_kw).test_dataloader()])
    ref = make_predict_fn(serve.load_run_model(run_folder).eval(),
                          with_saliency=False)(test)[0]
    top2 = ref.topk(2, -1).values
    held = (top2[:, 0] - top2[:, 1]) > 0.1
    for extra in ([], ["--int8_calib", "3"]):
        args = serve.parse_args(["--run_folder", str(run_folder), "--dtype",
                                 "float32", "--port", "0", "--batch_size",
                                 "2", "--int8", *extra])
        model = serve.build_model(args, "cpu", **data_kw)
        assert isinstance(model.encoder.blocks_0.attn.qkv, QDense)
        assert (model.encoder.blocks_0.mlp.fc2.a_inv is not None) == bool(
            extra)
        server, predictor = serve.build_server(args, model)
        try:
            got = predictor.submit(vol, timeout=60)
        finally:
            server.shutdown()
            server.server_close()
            predictor.close()
        fn = make_predict_fn(model, with_saliency=False)
        np.testing.assert_allclose(got, fn(vol[None])[0].numpy()[0],
                                   atol=1e-6)
        p = fn(test)[0]
        np.testing.assert_allclose(p.numpy(), ref.numpy(), atol=0.05)
        assert (p.argmax(-1) == ref.argmax(-1))[held].all()
    calib = serve.calibration_volumes(run_folder, 3, **data_kw)
    assert calib.shape == (3, 1, 2, 28, 28)
    for bad in (["--int8_calib", "2"],
                ["--int8", "--int8_calib", "2", "--init_seed", "0"]):
        with pytest.raises(SystemExit):
            serve.parse_args(bad)
    assert "--int8_calib" in capsys.readouterr().err


def test_int8_calibration_reads_the_runs_fold(run_folder, tmp_path,
                                              monkeypatch, capsys):
    """Static calibration on a LIDC run trained on fold 1: `serve --int8
    --int8_calib N --path_root P --run_folder R` and `export` with the same
    flags calibrate on fold 1's val volumes, bit for bit JAX's
    `calibration_volumes` (which reads the run's fold), not on fold 0's;
    without --path_root both stop with JAX's usage error."""
    import shutil

    from mst_tpu.serve import calibration_volumes as jax_calibration_volumes
    from mst_tpu_torch import export as ex
    from mst_tpu_torch.data import fixtures
    from mst_tpu_torch.registry import get_dataset
    from mst_tpu_torch.utils.checkpoint import load_hparams

    root = fixtures.write_lidc(tmp_path / "lidc", 6, shape_xyz=(40, 36, 12))
    split_csv = root / "preprocessed" / "splits" / "split.csv"
    with split_csv.open() as f:
        header, *rows = list(csv.reader(f))
    # fold 1: the splits shifted, so that its val cases are fold 0's train
    shifted = rows[-2:] + rows[:-2]
    fold1 = [r[:6] + ["1", s[7]] for r, s in zip(rows, shifted)]
    fixtures._write_csv(split_csv, header, rows + fold1)
    run = tmp_path / "runs" / "LIDC" / run_folder.name
    shutil.copytree(run_folder, run)
    for hp in run.glob("*.hparams.json"):
        hparams = json.loads(hp.read_text())
        hp.write_text(json.dumps(dict(hparams, dataset="LIDC", fold=1)))
    assert load_hparams(run)["fold"] == 1
    ref = np.asarray(jax_calibration_volumes(run, root, 3))
    val0 = get_dataset("LIDC", "val", path_root=root)
    fold0 = np.stack([np.asarray(val0[i]["source"]) for i in range(2)])
    assert ref.shape == (2, 1, 32, 224, 224) and ref.dtype == np.float32
    assert not np.array_equal(fold0, ref)
    np.testing.assert_array_equal(serve.calibration_volumes(run, 3, root),
                                  ref)

    seen = []

    def quantize(model, calib=None):
        seen.append(calib)
        return model

    monkeypatch.setattr(tq, "quantize_mst_int8", quantize)
    monkeypatch.setattr(ex, "save_exported",
                        lambda out, *a, **kw: Path(out).mkdir() or Path(out))
    flags = ["--run_folder", str(run), "--int8", "--int8_calib", "3"]
    serve.build_model(serve.parse_args(
        flags + ["--path_root", str(root), "--dtype", "float32"]), "cpu")
    ex.main(flags + ["--path_root", str(root), "--out",
                     str(tmp_path / "art")], device="cpu")
    assert len(seen) == 2
    for calib in seen:
        assert calib.dtype == ref.dtype
        np.testing.assert_array_equal(calib, ref)
    # no root: JAX's usage error, before any volume is read
    with pytest.raises(SystemExit, match="--int8_calib: .*--path_root"):
        serve.build_model(serve.parse_args(flags), "cpu")
    with pytest.raises(SystemExit, match="--int8_calib: .*--path_root"):
        ex.main(flags + ["--out", str(tmp_path / "art2")], device="cpu")
    assert len(seen) == 2
