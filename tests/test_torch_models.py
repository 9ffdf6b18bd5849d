"""The port's whole serving forward (`mst_tpu_torch.models.vit_fast.
fused_mst_logits`) against `mst_tpu`'s fused forward (Pallas kernels in
interpret mode, f32) and the flax model, on the same weights: flax
`init`, O(1) LayerScale gammas, `flatten_dict`, then `params_from_flax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.vit import interpolate_pos_embed as jax_interp
from mst_tpu.models.vit_fast import fused_mst_logits as jax_fused_mst_logits
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit import interpolate_pos_embed
from mst_tpu_torch.models.vit_fast import (
    _linear_resize_weights,
    fused_mst_logits,
)
from mst_tpu_torch.ops import fused_block as tfb

TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_fused_block.py:235
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)


def _pair(model_kw, shape, seed=0, mask=None):
    """(jax model, jax params, port model with the same weights, volume)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JaxMST(out_ch=2, use_flash=False, **model_kw)
    init_x = jnp.asarray(x[:, :, :4])
    init_m = None if mask is None else jnp.asarray(mask[:, :4])
    params = jm.init(jax.random.PRNGKey(seed), init_x, init_m)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **model_kw), flat)
    return jm, jparams, tm, x


CASES = {
    "tiny": (TINY, (2, 1, 3, 28, 28), False),
    "tiny_mask_gelu_erf": (dict(TINY, gelu_approximate=False),
                           (2, 1, 4, 28, 28), True),
    "tiny128_mask": (dict(TINY, model_size="tiny128"), (2, 1, 4, 28, 28), True),
    "slice_pos_emb_mask": (dict(TINY, use_slice_pos_emb=True),
                           (2, 1, 5, 28, 28), True),
    # D > MAX_SLICES: the slice table is depth-interpolated, not clamped
    "slice_pos_emb_d264": (dict(TINY, use_slice_pos_emb=True),
                           (1, 1, 264, 14, 14), False),
    # grid 2x2 at 28 px: the pos-embed is used as it is (every other case
    # resamples the 37x37 grid); registers, bottleneck, eps 1e-5, no ls
    "native_grid_registers_bottleneck": (
        dict(TINY, pos_embed_grid=2, num_register_tokens=2,
             use_bottleneck=True, norm_eps=1e-5, layerscale_init=None),
        (1, 1, 2, 28, 28), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_mst_logits_matches_mst_tpu_and_flax(case):
    model_kw, shape, with_mask = CASES[case]
    mask = None
    if with_mask:
        mask = np.zeros(shape[:1] + shape[2:3], bool)
        mask[0, -2:] = True  # the first volume's last two slices are padding
    jm, jparams, tm, x = _pair(model_kw, shape, mask=mask)
    jmask = None if mask is None else jnp.asarray(mask)
    ref_fused = jax_fused_mst_logits(jparams, jnp.asarray(x), jm,
                                     src_key_padding_mask=jmask,
                                     dtype=jnp.float32)
    ref_flax = jm.apply({"params": jparams}, jnp.asarray(x), jmask)
    tfb.reset_launch_counts()
    with torch.no_grad():
        out = fused_mst_logits(
            tm, torch.from_numpy(x),
            None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref_fused), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref_flax), **TOL)
    assert set(tfb.launch_counts().values()) == {0}
    assert set(tfb.sublayer_calls().values()) == {0}


def test_params_from_flax_raises_on_missing_and_unused_keys():
    tm = DinoSliceClassifier(out_ch=2, **TINY)
    flat = random_flax_params(tm, 0)
    params_from_flax(tm, flat)
    missing = dict(flat)
    del missing["encoder/blocks_1/mlp/fc2/kernel"]
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(tm, missing)
    extra = dict(flat, **{"encoder/blocks_9/attn/qkv/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="unused"):
        params_from_flax(tm, extra)
    bad = dict(flat, **{"head/kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="head"):
        params_from_flax(tm, bad)


@pytest.mark.parametrize("kw", [dict(TINY), dict(TINY, use_slice_pos_emb=True,
                                                 use_bottleneck=True,
                                                 num_register_tokens=2)])
def test_random_flax_params_match_the_flax_tree(kw):
    """Same names and shapes as the flax init tree, and seeded."""
    jm = JaxMST(out_ch=2, use_flash=False, **kw)
    ref = flatten_dict(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 1, 2, 28, 28)))["params"], sep="/")
    tm = DinoSliceClassifier(out_ch=2, **kw)
    flat = random_flax_params(tm, 7)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    again = random_flax_params(tm, 7)
    assert all(np.array_equal(flat[k], again[k]) for k in flat)


@pytest.mark.parametrize("grid", [(2, 2), (16, 16), (3, 5)])
def test_interpolate_pos_embed_matches_jax(grid):
    pe = np.random.default_rng(4).standard_normal((1, 1 + 37 * 37, 8)
                                                  ).astype(np.float32)
    ref = jax_interp(jnp.asarray(pe), grid, (37, 37))
    out = interpolate_pos_embed(torch.from_numpy(pe), grid, (37, 37))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("d", [257, 300, 1024])
def test_linear_resize_weights_match_jax_image_resize(d):
    table = np.random.default_rng(5).standard_normal((256, 6)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(table), (d, 6), "linear")
    out = _linear_resize_weights(d, 256) @ table
    # jax builds its weights in f32, these are rounded from f64
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)
