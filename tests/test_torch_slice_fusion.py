"""The slice-fusion options of the MST-DINO models (`--slice_fusion average
| linear | none`, `--rotary RoPE | LiRE`) on the CPU against `mst_tpu`, in
f32 on the same weights and inputs (numpy seeds):

- `apply_rope` (1D, theta 256) and `apply_liere` vs `mst_tpu.ops.rotary`:
  within 2e-5; `flat_to_skew` exactly; `liere_rotations`
  (`torch.linalg.matrix_exp`) vs JAX's `jax.scipy.linalg.expm` within
  EXPM_TOL at the generators' init scale and vs the exact exponential
  within EXACT_TOL (see `test_liere_matches_mst_tpu`);
- a tiny `DinoSliceClassifier` in each fusion, with and without a
  key-padding mask: logits of the fused path (and of the composed path)
  within 1e-4 of flax, the train forward's grads (the LiRE generators
  included) within 5e-4 of `jax.grad`;
- saliency with uniform slice weights (average / linear) and the rotary
  fusions' slice attention vs the JAX flax explainability path: within
  1e-4;
- `fold_linear_fusion` bit for bit; the fusion layer's post-norm and GELU
  options vs flax;
- int8 params in these configurations raise JAX's ValueError (serving,
  saliency, the train step), and `--int8` training warns and trains
  unquantized, as JAX's `fit`."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.linalg
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models import convert as jconv
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.slice_fusion import \
    TransformerEncoderLayer as JaxFusionLayer
from mst_tpu.ops import fused_int8 as jq
from mst_tpu.ops import rotary as jrot
from mst_tpu.train.predictor import _forward_with_saliency
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu_torch.models import convert
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.slice_fusion import TransformerEncoderLayer
from mst_tpu_torch.models.vit_fast import (
    fused_mst_logits,
    fused_mst_saliency,
    int8_config_supported,
)
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import rotary as trot
from mst_tpu_torch.ops.fused_int8 import (
    quantize_frozen_encoder_int8,
    quantize_mst_int8,
)
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    cross_entropy_loss,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
ROT_TOL = 2e-5
# |matrix_exp - JAX's expm| over the rotations' entries at the generators'
# init scale normal(0.02): measured at most 1.5e-6 (blocks of 2 to 32,
# positions 0..32), held to 3e-6; |matrix_exp - exact| at most 1.2e-5 up
# to normal(0.5), held to 2e-5
EXPM_TOL = 3e-6
EXACT_TOL = 2e-5
TOL = 1e-4
GRAD_TOL = 5e-4
SAL_TOL = 1e-4
CONFIGS = {
    "average": dict(slice_fusion="average"),
    "linear": dict(slice_fusion="linear"),
    "none": dict(slice_fusion="none"),
    "rope": dict(rotary="RoPE"),
    "liere": dict(rotary="LiRE"),
}
D = 4


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol,
                               rtol=0, err_msg=what)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _models(cfg, seed=0):
    """(port model, flax model, flat params) on the same seeded weights
    with O(1) LayerScale and LiRE generators (normal(0.5)), so that every
    block and rotation counts."""
    kw = dict(TINY, **CONFIGS[cfg])
    tkw = dict(kw, num_slices=D) if cfg in ("linear", "none") else kw
    tm = DinoSliceClassifier(out_ch=2, **tkw)
    flat = convert.random_flax_params(tm, seed)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
        elif k.endswith("liere_generators"):
            flat[k] = (0.5 * rng.standard_normal(flat[k].shape)).astype(
                np.float32)
    convert.params_from_flax(tm, flat)
    return tm, JaxMST(out_ch=2, use_flash=False, **kw), flat


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _volumes(seed=1, b=2):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal((b, 1, D, 28, 28)).astype(np.float32)
    mask = np.zeros((b, D), bool)
    mask[0, -2:] = True  # the first volume's last two slices are padding
    return vols, mask


# -- ops/rotary.py ------------------------------------------------------------


def test_apply_rope_1d_matches_mst_tpu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 33, 32)).astype(np.float32)
    ang = jrot.rope_angles(33, 32, theta=256.0)
    _close(trot.rope_angles(33, 32, theta=256.0), ang, 0.0)
    _close(trot.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.array(ang))), jrot.apply_rope(jnp.asarray(x), ang), ROT_TOL)


@pytest.mark.parametrize("scale", [0.02, 0.5])
@pytest.mark.parametrize("block", [2, 4, 8, 16, 32])
def test_liere_matches_mst_tpu(block, scale):
    """LiRE at generators normal(scale): 0.02 is the init, 0.5 far past it
    (rotation angles up to ~16 rad over 33 positions). `matrix_exp` is
    held to the exact exponential (scipy's `expm` in f64) within EXACT_TOL
    at both; to JAX's f32 `expm` within EXPM_TOL at the init scale, where
    they agree to 1.5e-6 (measured here); at 0.5 JAX's f32 `expm` itself
    lies up to 1.9e-3 from the exact rotation (blocks of 2; the port's
    1.2e-5), so there the port is held to the exact one only. The
    application and the generators' grads vs JAX on the same rotations /
    at the init scale."""
    rng = np.random.default_rng(block)
    nb, length = 2, 33
    gen = (scale * rng.standard_normal(
        (nb, trot.num_skew_params(block)))).astype(np.float32)
    skew = trot.flat_to_skew(torch.from_numpy(gen), block)
    _close(skew, jrot.flat_to_skew(jnp.asarray(gen), block), 0.0)
    assert torch.equal(skew, -skew.transpose(-1, -2))
    pos = np.arange(length)
    rots = trot.liere_rotations(torch.from_numpy(gen), torch.from_numpy(pos),
                                block)
    assert tuple(rots.shape) == (length, nb, block, block)
    sk64 = skew.double().numpy()
    exact = np.stack([[scipy.linalg.expm(p * sk64[b]) for b in range(nb)]
                      for p in pos])
    _close(rots, exact, EXACT_TOL)
    if scale == 0.02:
        _close(rots, jrot.liere_rotations(jnp.asarray(gen), jnp.asarray(pos),
                                          block), EXPM_TOL)
    x = rng.standard_normal((2, 3, length, nb * block)).astype(np.float32)
    _close(trot.apply_liere(torch.from_numpy(x), rots),
           jrot.apply_liere(jnp.asarray(x), jnp.asarray(rots.numpy())),
           ROT_TOL)
    if scale != 0.02:
        return
    # the generators' grad (matrix_exp's autograd) vs jax.grad of expm
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(g):
        r = jrot.liere_rotations(g, jnp.asarray(pos), block)
        return jnp.sum(jrot.apply_liere(jnp.asarray(x), r) * w)

    tg = torch.from_numpy(gen).requires_grad_(True)
    (trot.apply_liere(torch.from_numpy(x), trot.liere_rotations(
        tg, torch.from_numpy(pos), block)) * torch.from_numpy(w)).sum(
    ).backward()
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(gen)))
    _close(tg.grad, ref, GRAD_TOL * np.abs(ref).max())


@pytest.mark.parametrize("norm_first", [True, False])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("rotary", [None, "RoPE", "LiRE"])
def test_fusion_layer_options_match_flax(norm_first, activation, rotary):
    rng = np.random.default_rng(3)
    e, heads, s = 32, 4, 5
    x = rng.standard_normal((2, s, e)).astype(np.float32)
    mask = np.zeros((2, s), bool)
    mask[1, 3:] = True
    jm = JaxFusionLayer(d_model=e, nhead=heads, dim_feedforward=2 * e,
                        activation=activation, norm_first=norm_first,
                        rotary=rotary)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params,
                                                      sep="/").items()}
    for k in flat:  # non-trivial LN and LiRE
        flat[k] = flat[k] + (0.3 * rng.standard_normal(flat[k].shape)
                             ).astype(np.float32)
    tm = TransformerEncoderLayer(e, heads, 2 * e, activation, norm_first,
                                 rotary)
    convert.params_from_flax(tm, flat)
    ref = jm.apply({"params": _tree(flat)}, jnp.asarray(x),
                   key_padding_mask=jnp.asarray(mask))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)).detach(), ref,
           TOL)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_logits_match_flax(cfg, with_mask):
    tm, jm, flat = _models(cfg)
    vols, mask = _volumes()
    mask = mask if with_mask else None
    ref = jm.apply({"params": _tree(flat)}, jnp.asarray(vols), _j(mask))
    tfb.reset_launch_counts()
    with torch.inference_mode():
        fused = fused_mst_logits(tm, _t(vols), _t(mask))
        composed = tm(_t(vols), _t(mask))
    assert set(tfb.launch_counts().values()) == {0}  # CPU: plain versions
    _close(fused, ref, TOL)
    _close(composed, ref, TOL)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_train_forward_grads_match_jax_grad(cfg, with_mask):
    """CE of the fused train forward and every parameter's grad (the LiRE
    generators included) vs jax.grad of the flax model."""
    tm, jm, flat = _models(cfg, seed=2)
    vols, mask = _volumes(seed=3)
    mask = mask if with_mask else None
    t = np.array([0, 1])

    def loss_flax(p):
        logits = jm.apply({"params": p}, jnp.asarray(vols), _j(mask))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(t)).mean()

    jloss, jgrads = jax.value_and_grad(loss_flax)(_tree(flat))
    loss = cross_entropy_loss(fused_mst_logits(tm, _t(vols), _t(mask),
                                               train=True), _t(t))
    loss.backward()
    _close(loss.item(), float(jloss), 1e-5)
    jflat = flatten_dict(jgrads, sep="/")
    named = dict(tm.named_parameters())
    assert {k.replace(".", "/") for k in named} == set(jflat)
    for name, p in named.items():
        ref = np.asarray(jflat[name.replace(".", "/")])
        _close(p.grad, ref, GRAD_TOL * max(np.abs(ref).max(), 1.0), name)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("cfg", ["average", "linear", "rope", "liere"])
def test_saliency_matches_flax_path(cfg, with_mask):
    """The fused `last` saliency: slice weights uniform at 1/D where the
    fusion has no attention (JAX's `_find_sowed` finds none), else the
    rotary fusion's slice attention; and TTA through both predict fns."""
    tm, jm, flat = _models(cfg, seed=4)
    vols, mask = _volumes(seed=5)
    mask = mask if with_mask else None
    probs_ref, sal_ref = _forward_with_saliency(
        jm, {"params": _tree(flat)}, jnp.asarray(vols), _j(mask),
        force_flax=True)
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(vols), _t(mask))
    _close(probs, probs_ref, SAL_TOL)
    _close(sal, sal_ref, SAL_TOL)
    jp, js = jax_make_predict_fn(jm, tta=True)(_tree(flat),
                                               jnp.asarray(vols), _j(mask))
    tp, ts = make_predict_fn(tm, tta=True)(vols, mask)
    _close(tp, jp, SAL_TOL)
    _close(ts, js, SAL_TOL)


def test_average_fusion_ignores_padded_slices():
    tm, _, _ = _models("average")
    vols, mask = _volumes()
    vols2 = vols.copy()
    vols2[0, :, -2:] = 100.0
    with torch.inference_mode():
        a = fused_mst_logits(tm, _t(vols), _t(mask))
        b = fused_mst_logits(tm, _t(vols2), _t(mask))
    assert torch.equal(a[0], b[0])


def test_linear_head_takes_its_slice_count():
    tm, _, _ = _models("linear")
    assert tuple(tm.head.kernel.shape) == (D * tm.emb_ch, 2)
    with pytest.raises(ValueError, match="takes 4 slices"):
        fused_mst_logits(tm, torch.zeros(1, 1, D + 1, 28, 28))
    # the reference's 32 slices where none is given
    assert DinoSliceClassifier(slice_fusion="none", **TINY).num_slices == 32


def test_fold_linear_fusion_bit_for_bit():
    rng = np.random.default_rng(6)
    de, e = D * 32, 32
    flat = {"fusion_linear/kernel": rng.standard_normal((de, e)),
            "fusion_linear/bias": rng.standard_normal(e),
            "head/kernel": rng.standard_normal((e, 2)),
            "head/bias": rng.standard_normal(2),
            "encoder/norm/scale": np.ones(e)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    ref = jconv.fold_linear_fusion(unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()}))
    ours = convert.fold_linear_fusion(flat)
    ref = flatten_dict(ref, sep="/")
    assert set(ours) == set(ref)
    for k in ref:
        assert np.array_equal(ours[k], np.asarray(ref[k])), k
    assert convert.fold_linear_fusion(ours) == ours  # already folded


@pytest.mark.parametrize("cfg", ["average", "linear", "liere"])
def test_int8_is_refused_as_in_jax(cfg, caplog):
    tm, jm, flat = _models(cfg)
    assert not int8_config_supported(tm)
    assert int8_config_supported(DinoSliceClassifier(out_ch=2, **TINY))
    vols, _ = _volumes()
    jq8 = jq.quantize_mst_params_int8(_tree(flat), jm)
    with pytest.raises(ValueError, match="int8"):
        jax_make_predict_fn(jm, with_saliency=False)(jq8, jnp.asarray(vols),
                                                     None)
    q = quantize_mst_int8(tm)
    for saliency in (False, True):
        with pytest.raises(ValueError, match="int8"):
            make_predict_fn(q, with_saliency=saliency)(vols)
    frozen = DinoSliceClassifier(out_ch=2, freeze=True, num_slices=D,
                                 **dict(TINY, **CONFIGS[cfg]))
    convert.params_from_flax(frozen, flat)
    enc = quantize_frozen_encoder_int8(frozen)
    state = TrainState(frozen, make_optimizer(frozen.parameters(), 1e-3))
    with pytest.raises(ValueError, match="int8"):
        make_train_step(state, enc)
    with pytest.raises(ValueError, match="int8"):
        make_eval_step(frozen, enc)
    with caplog.at_level(logging.WARNING):
        assert Trainer.__new__(Trainer).int8_encoder(frozen, None) is None
    assert "--int8 ignored" in caplog.text
