"""Saliency above `FUSED_MAX_TOKENS` = 512 tokens in the port on CPU tensors
against `mst_tpu`, in f32 on the same numpy inputs.

JAX serves it on its flax path (`_forward_with_saliency`, `return_weights`:
`attention_reference` sows every block's per-head [N, H, S, S]
probabilities). The port runs the composed path with `flash_fwd`'s LSE and
one saliency kernel per block (`ops/attention.flash_row`, `flash_carry`,
`flash_abnar`, csrc/flash_sal.cu), which rebuild what the plane mode needs
without any [S, S] matrix of a head. On the CPU every wrapper takes its
plain version, so these tests pin the plain versions the kernels are held
to on the card (`chip_smoke.py` phase 53):

- the port's probs and maps in each plane mode, with and without a
  key-padding mask, against `_forward_with_saliency(force_flax=True)` for
  a tiny ViT/14 at 322 px (S = 530) and a tiny DINOv3 (patch 16, 4
  registers, RoPE) at 368 px (S = 534); TTA against JAX `make_predict_fn`;
- the three plain versions against `plane_attention`,
  `attention_cls_rollout` and `attention_rollout` on JAX
  `attention_reference` probabilities;
- the composed serving path's bits with no saliency switch, and the
  saliency forward's probs equal to it;
- `rollout_abnar` keeping no factor past its block;
- the kernels' launch geometry (`flash_sal_launch`) against the source's
  constants at the model lengths, and the wrappers' refusals before any
  launch.

Tolerances: probs 1e-5 and maps atol 1e-5 / rtol 1e-4
(tests/test_torch_saliency.py), the kernel functions 2e-5
(tests/test_attention.py).
"""

import math
import re
import weakref

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
    row, the Abnar factors -> `attention_rollout`."""
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
        factors = [TA.flash_abnar(_t(q), _t(k), _port_lse(q, k, v))
                   for q, k, v in layers]
        for f, p in zip(factors, probs):  # rows of mean + I, normalised
            a = np.asarray(p).mean(1) + np.eye(s, dtype=np.float32)
            np.testing.assert_allclose(
                f.numpy(), a / a.sum(-1, keepdims=True), **KERNEL_TOL)
        got = tsal.attention_rollout_from_factors(factors, n_prefix)
        ref = jsal.attention_rollout(probs, n_prefix)
    _no_launches()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)


def test_flash_attention_saliency_output_is_the_serving_output():
    """The saliency forms keep `flash_fwd`'s o bit for bit; one switch at a
    time."""
    q, k, v = map(_t, _blocks(6, n=1, s=77)[0])
    o = TA.flash_attention(q, k, v)
    lse = _port_lse(q.numpy(), k.numpy(), v.numpy())
    carry = torch.rand(2, 2, 77, generator=torch.Generator().manual_seed(0))
    for kw, fn in ((dict(want_row=True), lambda: TA.flash_row(q, k, lse)),
                   (dict(carry=carry),
                    lambda: TA.flash_carry(q, k, lse, carry)),
                   (dict(abnar=True), lambda: TA.flash_abnar(q, k, lse))):
        o2, extra = TA.flash_attention_saliency(q, k, v, **kw)
        assert torch.equal(o2, o) and torch.equal(extra, fn())
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
    """`forward_saliency("rollout_abnar")` chains each factor into the
    running product as it comes: when a block's factor is made, no earlier
    factor is alive but block 0's, which is the product until block 1
    multiplies it (JAX's flax path holds every block's probabilities). A
    tiny encoder of 4 blocks."""
    monkeypatch.setitem(vit_mod._VIT_CONFIGS, "tiny",
                        dict(vit_mod._VIT_CONFIGS["tiny"], depth=4))
    tm, _, _ = _models(TINY, 9)
    assert tm.encoder.depth == 4
    vols, _ = _volumes(PX, seed=10, b=1, d=1)
    made, alive_at_call = [], []
    real = TA.SAL_KERNELS.abnar

    def tracked(*a, **kw):
        alive_at_call.append(sum(r() is not None for r in made))
        out = real(*a, **kw)
        made.append(weakref.ref(out))
        return out

    monkeypatch.setattr(TA.SAL_KERNELS, "abnar", tracked)
    with torch.inference_mode():
        fused_mst_saliency(tm, _t(vols), plane_mode="rollout_abnar")
    assert alive_at_call == [0, 1, 0, 0]


# -- the kernels' geometry and refusals ---------------------------------------

SAL_LENGTHS = (1, 77, 513, 530, 1029, 1370, 1601)
SAL_HEADS = (2, 6, 12, 16, 24)
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block


def _constants():
    """The `constexpr` ints of csrc/flash_sal.cu, evaluated in order."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "flash_sal.cu").read_text())
    env = {}
    for key, expr in re.findall(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);",
                                text):
        env[key] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env, text


def test_sal_geometry_mirrors_the_source():
    c, text = _constants()
    assert (c["SAL_TILE"], c["SAL_THREADS"]) == (TA.SAL_TILE, TA.SAL_THREADS)
    assert c["SAL_HD"] == TA.HEAD_DIM and c["SAL_TILE_BYTES"] == 8192
    assert c["SAL_CARRY_SMEM"] == TA.flash_sal_launch(1, 1, 1, "row").smem
    assert ("return size_t(H) * SAL_TILE_BYTES + 2 * SAL_TILE_BYTES + "
            "size_t(H) * SAL_TILE * 4;") in text
    assert TA.flash_sal_launch(1, TA.SAL_MAX_HEADS, 1, "abnar").smem \
        <= SMEM_LIMIT < TA.flash_sal_launch(1, TA.SAL_MAX_HEADS + 1, 1,
                                            "abnar").smem
    assert TA.SAL_MAX_HEADS >= 24  # giant2
    # the kernels: mma.sync on ldmatrix fragments, cp.async, no float
    # atomics (the same bits on every run); the ROW form one query tile
    assert "mma_16816" in text and "ldmatrix" in text and "cp_async16" in text
    assert "atomicAdd" not in text
    assert "const int nq = ROW ? 1 : T;" in text
    assert "qi < a.S ? lse[qi] : SAL_LSE_PAD" in text
    # the Abnar rule of `mhsa_abnar`: heads summed in order, times 1 / H,
    # plus I, divided by the row's sum
    assert "__fadd_rn(__fmul_rn(ab[4 * nb + e], a.inv_h)" in text
    assert "__fdiv_rn(v, e & 2 ? rs1 : rs0)" in text
    assert "mst_flash_sal_geometry" in text


@pytest.mark.parametrize("heads", SAL_HEADS)
@pytest.mark.parametrize("s", SAL_LENGTHS)
def test_sal_units_cover_every_key_and_row_once(s, heads):
    b = 3
    for part in TA.SAL_PARTS:
        g = TA.flash_sal_launch(b, heads, s, part)
        assert g.tiles == -(-s // 64) and g.threads == 128
        owners = torch.zeros(b, heads, g.tiles * 64, dtype=torch.int32)
        if part == "abnar":  # a unit: query tile (fastest), slice
            assert g.blocks == g.tiles * b and g.walks == 2 * g.tiles * heads
            for u in range(g.blocks):
                tile, sl = u % g.tiles, u // g.tiles
                owners[sl, :, tile * 64:tile * 64 + 64] += 1
            # every (key tile, head) step twice: the rows' sums, the values
            steps = [(i % (g.tiles * heads) // heads, i % heads)
                     for i in range(g.walks)]
            assert sorted(steps) == sorted(
                [(j, h) for j in range(g.tiles) for h in range(heads)] * 2)
            assert g.smem == heads * (8192 + 256) + 2 * 8192
        else:  # a unit: key tile (fastest), head, slice
            assert g.blocks == g.tiles * heads * b
            assert g.walks == (1 if part == "row" else g.tiles)
            for u in range(g.blocks):
                bh, tile = divmod(u, g.tiles)
                owners[bh // heads, bh % heads, tile * 64:tile * 64 + 64] += 1
            assert g.smem == 3 * 8192 + 2 * 128 * 4
        assert bool((owners[..., :s] == 1).all())
        # each warp's 16 rows start below the tile's end; the last tile
        # holds at least one row
        assert s - (g.tiles - 1) * 64 >= 1


def test_sal_model_lengths():
    """518 px ViT-S/14 (S = 1370): 22 tiles, the last one 26 rows; DINOv3
    at 512 px (1029): 17 tiles; at B=8 (256 slices, 6 heads) the carry
    runs 33,792 blocks, the Abnar kernel 5,632 of 65,536 bytes."""
    assert TA.flash_sal_launch(256, 6, 1370, "carry").blocks == 33_792
    g = TA.flash_sal_launch(256, 6, 1370, "abnar")
    assert (g.tiles, g.blocks, g.smem) == (22, 5_632, 67_072)
    assert TA.flash_sal_launch(1, 6, 1029, "row").tiles == 17


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
    q, k, lse, _ = _operands(heads=TA.SAL_MAX_HEADS + 1)
    with pytest.raises(ValueError, match="at most 25 heads"):
        TA.flash_abnar(q, k, lse)


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
