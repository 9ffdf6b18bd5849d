"""Saliency above `FUSED_MAX_TOKENS` = 512 tokens in the port on CPU tensors
against `mst_tpu`, in f32 on the same numpy inputs.

JAX serves it on its flax path (`_forward_with_saliency`, `return_weights`:
`attention_reference` sows every block's per-head [N, H, S, S]
probabilities). The port runs the composed path with `flash_fwd`'s LSE and
one saliency kernel per block (`ops/attention.flash_row`, `flash_carry`,
`flash_abnar`, csrc/flash_sal.cu), which rebuild what the plane mode needs
without any [S, S] matrix of a head; `rollout_abnar` keeps each block's
q, k, LSE and row normaliser and carries the CLS row back through the
blocks (`abnar_rollout_row`, one `flash_carry` a block). On the CPU every
wrapper takes its plain version, so these tests pin the plain versions the
kernels are held to on the card (`chip_smoke.py` phase 53):

- the port's probs and maps in each plane mode, with and without a
  key-padding mask, against `_forward_with_saliency(force_flax=True)` for
  a tiny ViT/14 at 322 px (S = 530) and a tiny DINOv3 (patch 16, 4
  registers, RoPE) at 368 px (S = 534); TTA against JAX `make_predict_fn`;
- the three plain versions against `plane_attention`,
  `attention_cls_rollout` and the row sums of `attention_rollout`'s
  factors on JAX `attention_reference` probabilities, and the row carried
  back against `attention_rollout` and the CLS row of its product;
- the composed serving path's bits with no saliency switch, and the
  saliency forward's probs equal to it;
- `rollout_abnar` returning a row, keeping no [S, S] tensor past a
  block's call and running no [S, S] product;
- the kernels' launch geometry (`flash_sal_launch`) against the source's
  constants at the model lengths, and the wrappers' refusals before any
  launch.

Tolerances: probs 1e-5 and maps atol 1e-5 / rtol 1e-4
(tests/test_torch_saliency.py), the kernel functions 2e-5
(tests/test_attention.py).
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.ops import saliency as jsal
from mst_tpu.ops.attention import attention_reference as jax_attention
from mst_tpu.train.predictor import _forward_with_saliency
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu_torch.models import vit as vit_mod
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import (
    FastViTConfig,
    fused_mst_saliency,
    fused_seq_len_ok,
    mst_logits,
    prepare_vit_tokens,
    slices_nhwc,
)
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import attention as TA
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import saliency as tsal
from mst_tpu_torch.ops.rotary import apply_rope_tables
from mst_tpu_torch.train.predictor import make_predict_fn

PROB_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_saliency.py
SAL_TOL = dict(atol=1e-5, rtol=1e-4)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_attention.py:29
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
TINY3 = dict(model_size="tiny", patch_size=16, num_register_tokens=4,
             use_rope_2d=True, rope_normalized=True, use_pos_embed=False,
             norm_eps=1e-5, fusion_heads=4)
PX, PX3 = 322, 368  # 23 x 23 patches: S = 530 (ViT/14), 534 (DINOv3/16)
MODES = ("last", "rollout", "rollout_abnar")
MODELS = {"v2": (TINY, PX), "v3": (TINY3, PX3)}


def _no_launches():
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch


def _models(kw, seed=0):
    """(port model, flax model, flax params) on the same seeded weights with
    O(1) LayerScale, so that every block counts."""
    tm = DinoSliceClassifier(out_ch=2, **kw)
    flat = random_flax_params(tm, seed)
    rng = np.random.default_rng(seed)
    for key in flat:
        if key.endswith("/gamma"):
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    params_from_flax(tm, flat)
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})
    return tm.eval(), JaxMST(out_ch=2, use_flash=False, **kw), jparams


def _volumes(px, seed=1, b=2, d=3):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal((b, 1, d, px, px)).astype(np.float32)
    mask = np.zeros((b, d), bool)
    mask[0, -1] = True  # the first volume's last slice is padding
    return vols, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


# -- the model against the flax explainability path --------------------------


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("plane_mode", MODES)
@pytest.mark.parametrize("name", list(MODELS))
def test_long_saliency_matches_flax_path(name, plane_mode, with_mask):
    kw, px = MODELS[name]
    tm, jm, jparams = _models(kw)
    vols, mask = _volumes(px)
    mask = mask if with_mask else None
    assert not fused_seq_len_ok(tm, px, px)
    probs_ref, sal_ref = _forward_with_saliency(
        jm, {"params": jparams}, jnp.asarray(vols),
        None if mask is None else jnp.asarray(mask), plane_mode=plane_mode,
        force_flax=True)
    tfb.reset_launch_counts()
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(vols), _t(mask),
                                        plane_mode=plane_mode)
    _no_launches()
    assert tuple(sal.shape) == (2, 3, px, px) and sal.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref),
                               **PROB_TOL)
    np.testing.assert_allclose(sal.numpy(), np.asarray(sal_ref), **SAL_TOL)
    # the maps are ~1e-3 here, so also relative to their largest value
    scale = np.abs(np.asarray(sal_ref)).max()
    np.testing.assert_allclose(sal.numpy() / scale,
                               np.asarray(sal_ref) / scale, atol=1e-4)
    if with_mask:  # the padded slice carries no slice attention
        assert float(sal[0, -1].abs().max()) == 0.0


@pytest.mark.parametrize("plane_mode", MODES)
def test_long_tta_saliency_matches_jax_make_predict_fn(plane_mode):
    tm, jm, jparams = _models(TINY, 3)
    vols, mask = _volumes(PX, seed=4, b=1, d=2)
    ref_p, ref_s = jax_make_predict_fn(jm, tta=True, with_saliency=True,
                                       plane_mode=plane_mode)(
        jparams, jnp.asarray(vols), jnp.asarray(mask))
    probs, sal = make_predict_fn(tm, tta=True, plane_mode=plane_mode)(
        vols, mask)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), **PROB_TOL)
    np.testing.assert_allclose(sal.numpy(), np.asarray(ref_s), **SAL_TOL)


def test_long_saliency_refuses_int8_as_jax_does():
    """An int8 model above 512 tokens: JAX's ValueError (its flax path has
    no int8 form), from the predict fn and from `fused_mst_saliency`."""
    from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
    tm, _, _ = _models(TINY, 5)
    tq = quantize_mst_int8(tm)
    vols, _ = _volumes(PX, b=1, d=1)
    for mode in MODES:
        with pytest.raises(ValueError, match="int8"):
            make_predict_fn(tq, plane_mode=mode)(vols)
        with pytest.raises(ValueError, match="int8"):
            fused_mst_saliency(tq, _t(vols), plane_mode=mode)


# -- the plain kernel versions against XLA's reductions of the probs ----------


def _blocks(seed, n=3, b=2, h=2, s=530, d=16):
    """q, k, v of n attention layers [b, h, s, d] f32, scaled so that the
    softmax rows are far from uniform."""
    rng = np.random.default_rng(seed)
    return [[(2.0 * rng.standard_normal((b, h, s, d))).astype(np.float32)
             for _ in range(3)] for _ in range(n)]


def _port_lse(q, k, v):
    _, lse = TA.flash_fwd(_t(q), _t(k), _t(v), want_lse=True)
    return lse


@pytest.mark.parametrize("part", TA.SAL_PARTS)
def test_plain_kernel_versions_match_jax_saliency(part):
    """Each plain version on the flash forward's LSE against the JAX
    reduction of `attention_reference`'s probabilities: the CLS row ->
    `plane_attention`, the carry chain -> `attention_cls_rollout`'s CLS
    row, the row normaliser -> the row sums of `attention_rollout`'s
    factors (head mean + I, built with jax.numpy), and the row carried
    back through the blocks -> `attention_rollout`."""
    s = 534  # 5 prefix tokens (CLS, 4 registers) + 23 x 23 patches
    layers = _blocks({"row": 0, "carry": 1, "abnar": 2}[part], s=s)
    probs = [jax_attention(*map(jnp.asarray, qkv), return_weights=True)[1]
             for qkv in layers]
    n_prefix, grid = 5, (23, 23)
    tfb.reset_launch_counts()
    if part == "row":
        q, k, v = layers[-1]
        row = TA.flash_row(_t(q), _t(k), _port_lse(q, k, v))
        np.testing.assert_allclose(row.numpy(), np.asarray(probs[-1][:, :, 0]),
                                   **KERNEL_TOL)
        got = tsal.plane_attention_from_row(row, n_prefix, grid)
        ref = jsal.plane_attention(probs[-1], n_prefix, grid)
    elif part == "carry":
        carry = torch.zeros(2, 2, s)
        carry[:, :, 0] = 1.0
        for q, k, v in layers:
            carry = TA.flash_carry(_t(q), _t(k), _port_lse(q, k, v), carry)
        chain = jsal.attention_cls_rollout(probs)
        np.testing.assert_allclose(carry.numpy(), np.asarray(chain[:, :, 0]),
                                   **KERNEL_TOL)
        got = tsal.plane_attention_from_row(carry, n_prefix, grid)
        ref = jsal.plane_attention(chain, n_prefix, grid)
    else:
        states = []
        for (q, k, v), p in zip(layers, probs):
            lse = _port_lse(q, k, v)
            rs = TA.flash_abnar(_t(q), _t(k), lse)
            a = jnp.mean(p, axis=1) + jnp.eye(s, dtype=p.dtype)[None]
            assert tuple(rs.shape) == (2, s) and rs.dtype == torch.float32
            np.testing.assert_allclose(rs.numpy(), np.asarray(a.sum(-1)),
                                       **KERNEL_TOL)
            states.append((_t(q), _t(k), lse, rs))
        got = tsal.attention_rollout_from_row(TA.abnar_rollout_row(states),
                                              n_prefix)
        ref = jsal.attention_rollout(probs, n_prefix)
    _no_launches()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)


@pytest.mark.parametrize("n_layers", [1, 4])
def test_abnar_rollout_row_is_the_cls_row_of_the_factors_product(n_layers):
    """The row carried back through the blocks is the CLS row of JAX's
    product A_{L-1} ... A_0 of the factors rownorm(mean_h p + I) before its
    normalisation (the whole row, prefix tokens included), from one block
    and from four."""
    layers = _blocks(20 + n_layers, n=n_layers, s=77)
    states, factors = [], []
    for q, k, v in layers:
        lse = _port_lse(q, k, v)
        states.append((_t(q), _t(k), lse, TA.flash_abnar(_t(q), _t(k), lse)))
        p = jax_attention(*map(jnp.asarray, (q, k, v)),
                          return_weights=True)[1]
        a = jnp.mean(p, axis=1) + jnp.eye(77, dtype=p.dtype)[None]
        factors.append(a / a.sum(-1, keepdims=True))
    product = factors[0]
    for a in factors[1:]:
        product = jnp.einsum("bij,bjk->bik", a, product)
    row = TA.abnar_rollout_row(states)
    assert tuple(row.shape) == (2, 77) and row.dtype == torch.float32
    np.testing.assert_allclose(row.numpy(), np.asarray(product[:, 0]),
                               **KERNEL_TOL)
    assert abs(float(row.sum(-1).max()) - 1.0) < 1e-5  # rows of a stochastic product


def test_flash_attention_saliency_output_is_the_serving_output():
    """The saliency forms keep `flash_fwd`'s o bit for bit; one switch at a
    time."""
    q, k, v = map(_t, _blocks(6, n=1, s=77)[0])
    o = TA.flash_attention(q, k, v)
    lse = _port_lse(q.numpy(), k.numpy(), v.numpy())
    carry = torch.rand(2, 2, 77, generator=torch.Generator().manual_seed(0))
    for kw, fn in ((dict(want_row=True), lambda: TA.flash_row(q, k, lse)),
                   (dict(carry=carry),
                    lambda: TA.flash_carry(q, k, lse, carry))):
        o2, extra = TA.flash_attention_saliency(q, k, v, **kw)
        assert torch.equal(o2, o) and torch.equal(extra, fn())
    # the Abnar form: the block's state for the sweep back, q and k as
    # contiguous copies (no view of a packed qkv keeps it alive)
    o2, (q2, k2, lse2, rs) = TA.flash_attention_saliency(q, k, v, abnar=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(q2, q) and torch.equal(k2, k)
    assert q2.is_contiguous() and k2.is_contiguous()
    assert torch.equal(rs, TA.flash_abnar(q, k, lse))
    with pytest.raises(ValueError, match="one of"):
        TA.flash_attention_saliency(q, k, v, want_row=True, abnar=True)
    with pytest.raises(ValueError, match="one of"):
        TA.flash_attention_saliency(q, k, v)


# -- the composed serving path and the saliency forward -----------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_composed_serving_bits_unchanged_without_a_switch(name):
    """With no saliency switch `Attention.forward` is the flax composition
    on `flash_attention`, bit for bit; the saliency forward's encoder output
    and probs are the serving forward's in every mode (the flash output
    does not depend on the LSE kept beside it)."""
    kw, px = MODELS[name]
    tm, _, _ = _models(kw, 7)
    vols, _ = _volumes(px, seed=8, b=1, d=2)
    src = _t(vols)
    h, rc, rs = prepare_vit_tokens(tm.encoder, slices_nhwc(src),
                                   FastViTConfig.from_model(tm), torch.float32)
    blk = tm.encoder.block(0)
    with torch.inference_mode():
        x = blk.norm1(h)
        n, s, e = x.shape
        qkv = blk.attn.qkv(x).view(n, s, 3, 2, e // 2)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        if rc is not None:
            q, k = (apply_rope_tables(t, rc, rs) for t in (q, k))
        o = TA.flash_attention(q, k, v)
        want = blk.attn.proj(o.transpose(1, 2).reshape(n, s, e))
        assert torch.equal(blk.attn(x, rc, rs), want)
        serve_cls = tm.encoder(h, rc, rs)
        for mode in MODES:
            cls, _ = tm.encoder.forward_saliency(h, rc, rs, mode)
            assert torch.equal(cls, serve_cls), mode
        probs = torch.softmax(mst_logits(tm, src), -1)
        for mode in MODES:
            assert torch.equal(fused_mst_saliency(tm, src,
                                                  plane_mode=mode)[0], probs)


def test_rollout_abnar_keeps_no_factor_past_its_block(monkeypatch):
    """`forward_saliency("rollout_abnar")` returns the CLS row [N, S] of
    the factors' product, keeps no [S, S] tensor past a block's call (the
    plain versions build one head's [N, S, S] probabilities inside a call
    on the CPU) and runs no product of two [S, S] operands (the chain of
    factors is gone); one row normaliser a block, one carry a block. A tiny
    encoder of 4 blocks at 322 px (S = 530)."""
    import gc

    monkeypatch.setitem(vit_mod._VIT_CONFIGS, "tiny",
                        dict(vit_mod._VIT_CONFIGS["tiny"], depth=4))
    tm, _, _ = _models(TINY, 9)
    assert tm.encoder.depth == 4
    vols, _ = _volumes(PX, seed=10, b=1, d=1)
    src = _t(vols)
    h, rc, rs = prepare_vit_tokens(tm.encoder, slices_nhwc(src),
                                   FastViTConfig.from_model(tm), torch.float32)
    s = h.shape[1]
    assert s == 530

    def square(t):
        return t.dim() >= 2 and tuple(t.shape[-2:]) == (s, s)

    alive, products, calls = [], [], {"abnar": 0, "carry": 0}
    real_block = vit_mod.Block.forward_composed

    def block(self, *a, **kw):
        out = real_block(self, *a, **kw)
        gc.collect()
        alive.append(sum(1 for o in gc.get_objects()
                         if issubclass(type(o), torch.Tensor) and square(o)))
        return out

    real_matmul = torch.matmul

    def matmul(x, y, *a, **kw):
        products.append(square(x) and square(y))
        return real_matmul(x, y, *a, **kw)

    for part in calls:
        real = getattr(TA.SAL_KERNELS, part)

        def counted(*a, _real=real, _part=part, **kw):
            calls[_part] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(TA.SAL_KERNELS, part, counted)
    monkeypatch.setattr(vit_mod.Block, "forward_composed", block)
    monkeypatch.setattr(torch, "matmul", matmul)
    with torch.inference_mode():
        cls, row = tm.encoder.forward_saliency(h, rc, rs, "rollout_abnar")
    monkeypatch.undo()
    assert tuple(row.shape) == (1, s) and row.dtype == torch.float32
    assert alive == [0, 0, 0, 0]
    assert products and not any(products)
    assert calls == {"abnar": 4, "carry": 4}
    with torch.inference_mode():
        assert torch.equal(cls, tm.encoder(h, rc, rs))


# -- the kernels' geometry and refusals ---------------------------------------

SAL_LENGTHS = (1, 77, 513, 530, 1029, 1370, 1601)
SAL_HEADS = (2, 6, 12, 16, 24)
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block


def _constants():
    """The `constexpr` ints of csrc/flash_sal.cu, evaluated in order after
    those of the headers it builds on (attn_sm90.cuh, flash_sm90.cuh)."""
    env = {}
    for name in ("attn_sm90.cuh", "flash_sm90.cuh", "flash_sal.cu"):
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for key, expr in re.findall(
                r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", text):
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env, text


def test_sal_geometry_mirrors_the_source():
    c, text = _constants()
    assert (c["CARRY_N"], c["ABNAR_N"], c["SAL_STAGES"]) == (
        TA.SAL_CARRY_ROWS, TA.SAL_ABNAR_ROWS, TA.SAL_STAGES)
    assert c["SAL_BARS"] == 4 + 2 * TA.SAL_STAGES
    assert c["BOX"] == TA.FLASH_BOX and c["THREADS"] == TA.FLASH_THREADS
    assert TA.flash_sal_launch(1, 24, 1, "row", 132).smem <= SMEM_LIMIT
    assert TA.flash_sal_launch(1, 24, 1, "abnar", 132).smem <= SMEM_LIMIT
    # the flash kernels' blocks: persistent, TMA boxes through mbarrier
    # rings, wgmma scores (m64n64k16 / m64n128k16 a stage), no mma.sync or
    # float atomics (the same bits on every run); the ROW form one stage
    assert '#include "flash_sm90.cuh"' in text
    assert "tma_load_4d" in text and "wgmma_m64n128k16" in text
    assert "cp_async_arrive" in text and "reg_alloc<CONSUMER_REGS>" in text
    for gone in ("mma_16816", "ldmatrix", "cp_async16", "atomicAdd"):
        assert gone not in text, gone
    assert "nq = ROW ? 1 : sal_stages(a.S, CARRY_N)" in text
    assert ("cp_async4(v + vec_at(32 * e + lane), lse + (in ? q : 0), "
            "in ? 4 : 0);") in text
    # the Abnar row normaliser: the row sums, the heads in order, times 1 /
    # H, plus 1; no factor is written
    assert "hs0 += quad_sum(p0);" in text
    assert "__fadd_rn(__fmul_rn(hs0, a.inv_h), 1.0f)" in text
    assert "mst_flash_sal_geometry" in text


@pytest.mark.parametrize("heads", SAL_HEADS)
@pytest.mark.parametrize("s", SAL_LENGTHS)
def test_sal_units_cover_every_key_and_row_once(s, heads):
    """Each unit's rows (the carry's keys, the row normaliser's queries)
    and the ring stages it streams (the other operand's rows) cover every
    row of S once; the grid is one block an SM or one a unit."""
    b, sms = 3, 132
    for part in TA.SAL_PARTS:
        g = TA.flash_sal_launch(b, heads, s, part, sms)
        assert (g.rows, g.box, g.threads) == (128, 64, 384)
        assert g.tiles == -(-s // 128) and g.grid == min(g.units, sms)
        # a unit: 128 rows, 64 a consumer warpgroup
        owners = torch.zeros(b, heads, g.tiles * 128, dtype=torch.int32)
        if part == "abnar":  # a unit: query tile (fastest), slice
            assert g.units == g.tiles * b
            for u in range(g.units):
                tile, sl = u % g.tiles, u // g.tiles
                owners[sl, :, tile * 128:tile * 128 + 128] += 1
            per_head = g.walks // heads
            assert g.walks == heads * per_head
        else:  # a unit: key tile (fastest), head, slice
            assert g.units == g.tiles * heads * b
            for u in range(g.units):
                bh, tile = divmod(u, g.tiles)
                owners[bh // heads, bh % heads, tile * 128:tile * 128 + 128] += 1
            per_head = g.walks
        assert bool((owners[..., :s] == 1).all())
        # the stages a unit streams (64 queries, or 128 keys, each), the
        # last one holding a row of S; the ROW form the first stage (query
        # 0) alone
        rows = 128 if part == "abnar" else 64
        if part == "row":
            assert per_head == 1
        else:
            assert (per_head - 1) * rows < s <= per_head * rows
        # every consumer's first row lies in the tile; the last tile holds
        # a row of S
        assert s - (g.tiles - 1) * 128 >= 1


def test_sal_model_lengths():
    """518 px ViT-S/14 (S = 1370): 11 units of 128 rows, the last one 90
    rows; DINOv3 at 512 px (1029): 9; at B=8 (256 slices, 6 heads) the
    carry walks 16,896 units of 22 stages, the row normaliser 2,816 of 66,
    each on a persistent grid of one block an SM."""
    g = TA.flash_sal_launch(256, 6, 1370, "carry", 132)
    assert (g.tiles, g.units, g.walks, g.grid) == (11, 16_896, 22, 132)
    assert g.smem == 1024 + 32_768 + 65_536 + 4_096 + 160
    g = TA.flash_sal_launch(256, 6, 1370, "abnar", 132)
    assert (g.tiles, g.units, g.walks) == (11, 2_816, 66)
    assert g.smem == 1024 + 32_768 + 131_072 + 160
    assert TA.flash_sal_launch(1, 6, 1029, "row", 132).tiles == 9


def _no_library():
    raise AssertionError("the kernel library was reached")


def _operands(hd=64, dtype=torch.bfloat16, s=77, heads=6):
    qkv = torch.zeros(2, s, 3, heads, hd, dtype=dtype)
    q, k, _ = (u.transpose(1, 2) for u in qkv.unbind(2))
    return q, k, torch.zeros(2, heads, s), torch.zeros(2, heads, s)


SAL_REFUSED = {
    "head dim 32": (dict(hd=32), ValueError, "head dim 64"),
    "f32": (dict(dtype=torch.float32), TypeError, "bfloat16"),
    "f16": (dict(dtype=torch.float16), TypeError, "bfloat16"),
}


def _sal_call(part, q, k, lse, carry):
    if part == "row":
        return TA.flash_row(q, k, lse)
    if part == "carry":
        return TA.flash_carry(q, k, lse, carry)
    return TA.flash_abnar(q, k, lse)


@pytest.mark.parametrize("case", list(SAL_REFUSED))
@pytest.mark.parametrize("part", TA.SAL_PARTS)
def test_sal_wrappers_refuse_before_any_launch(monkeypatch, part, case):
    kw, exc, what = SAL_REFUSED[case]
    monkeypatch.setattr(TA, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(exc, match=what):
        _sal_call(part, *_operands(**kw))


def test_sal_wrappers_refuse_bad_vectors_and_heads(monkeypatch):
    monkeypatch.setattr(TA, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    q, k, lse, carry = _operands()
    with pytest.raises(ValueError, match="lse must be contiguous f32"):
        TA.flash_row(q, k, lse[:, :, :-1])
    with pytest.raises(ValueError, match="lse must be contiguous f32"):
        TA.flash_abnar(q, k, lse.double())
    with pytest.raises(ValueError, match="carry must be contiguous f32"):
        TA.flash_carry(q, k, lse, carry.transpose(1, 2).contiguous()
                       .transpose(1, 2))
    with pytest.raises(ValueError, match="sm_scale > 0"):
        TA.flash_carry(q, k, lse, carry, sm_scale=-1.0)
    # no head limit (the heads stream through the ring), but the units and
    # the [B, H, S] rows stay within int32
    big = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(
        2**12, 2**10, 2**9, 64)
    rows = torch.zeros(1, 1, 1).expand(2**12, 2**10, 2**9)
    with pytest.raises(ValueError, match="grid too large"):
        TA.flash_abnar(big, big, rows)


def test_sal_wrappers_accept_kernel_operands(monkeypatch):
    """Head views of a packed qkv, and contiguous (RoPE'd) q, k, pass the
    checks and reach the library (a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(TA, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    for s in (1, 530, 1370):
        q, k, lse, carry = _operands(s=s)
        for ops in ((q, k), (q.contiguous(), k.contiguous())):
            for part in TA.SAL_PARTS:
                with pytest.raises(Reached):
                    _sal_call(part, *ops, lse, carry)


def test_sm_scale_default_is_the_head_dim_rule():
    q, k, v = map(_t, _blocks(11, n=1, s=40, d=16)[0])
    lse = _port_lse(q.numpy(), k.numpy(), v.numpy())
    assert torch.equal(TA.flash_row(q, k, lse),
                       TA.flash_row(q, k, lse, 1.0 / math.sqrt(16)))
