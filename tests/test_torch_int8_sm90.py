"""The int8 first products of the W8A8 sub-layers as two kernels
(`mst_tpu_torch/csrc/ln_gemm_i8.cu`): `ln_quant_rows` (LN and quantization
once per row) and an int8 TMA + wgmma GEMM on the shared mainloop of
`gemm_sm90.cuh`, which reads the weights K-major (`QDense.q8t`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them, in f32 on the CPU.

- `ln_quant_rows`'s plain version against JAX's `_quant_rows(_ln(x))` /
  `_quant_static(_ln(x))` (`mst_tpu/ops/fused_int8.py`): the codes bit for
  bit, with exact .5 ties planted (LN columns whose scale is 0 hold their
  bias exactly); the row scales bit for bit on the same LN output, and
  through each framework's own LN within the f32 ulps of the rows'
  abs-maxima;
- the split plain versions (the codes, then the GEMM on the K-major
  weights) against the one-piece `_ln_gemm_i8_ref` /
  `_ln_gemm_i8_swiglu_ref`, bit for bit, in every output mode;
- `q8t` equal to `q8.T` for every quantized dense, dynamic and static,
  ViT and gated `tiny128` trees, quantized here or carried across from
  `mst_tpu`;
- the launch geometry (`ln_gemm_i8_launch`) at every K it accepts and
  ragged M, the gated tiles' h1 / h2 boxes, its constants against the
  sources, and the wrappers' refusals before any launch.

`chip_smoke.py` phases 2 and 45 hold the same geometry to the kernels'
own export and the kernels to these plain versions on the card."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu.ops import fused_int8 as jq
from mst_tpu_torch.models.convert import quantized_from_flax
from mst_tpu_torch.models.layers import QDense
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tq

EPS = 1e-6
ROWS = (1, 63, 128, 771, 8 * 32 * 201, 8 * 32 * 257)
# the path's first products: (K, N, gated) of ViT-S qkv / fc1, DINOv3's
# (the same), ViT-B / L and giant2's qkv, giant2's w12 (N = F)
PATH = ((384, 1152, False), (384, 1536, False), (768, 2304, False),
        (1024, 3072, False), (1536, 4608, False), (1536, 4096, True))
SMEM_LIMIT = 232_448


def _x(rng, m, k):
    return rng.standard_normal((m, k)).astype(np.float32)


def _ln_vectors(rng, k, ties: bool, amax127: bool):
    """LN scale / bias; with `ties` columns 1..8 hold exact .5 ties (scale
    0, bias k + 0.5), with `amax127` column 0 holds 127 (so that a dynamic
    row's scale is 127 * f32(1/127) = 1 and those ties stay ties)."""
    ln_s = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(k)).astype(np.float32)
    if ties:
        ln_s[1:9] = 0.0
        ln_b[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -4.5]
    if amax127:
        ln_s[0], ln_b[0] = 0.0, 127.0
    return ln_s, ln_b


def _ulps(a, b):
    """Largest distance of two f32 arrays in f32 ulps (same signs)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("amax127", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_ln_quant_rows_matches_jax(static, ties, amax127):
    """The codes bit for bit (planted .5 ties included: round half to
    even). The row scales: on the same LN output bit for bit; through each
    framework's own LN no further apart in f32 ulps than the rows' abs-max
    are (the two LNs sum the mean and variance in other orders)."""
    rng = np.random.default_rng(10 + 4 * static + 2 * ties + amax127)
    k = 384
    x = _x(rng, 257, k)
    ln_s, ln_b = _ln_vectors(rng, k, ties, amax127)
    if static:  # the folded activation scale: h in the codes' range
        ln_s, ln_b = ln_s * 30.0, ln_b * (30.0 if not ties else 1.0)
    tfb.reset_launch_counts()
    q, s = tq.ln_quant_rows(torch.from_numpy(x), torch.from_numpy(ln_s),
                            torch.from_numpy(ln_b), EPS, static)
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no launch
    h = jfb._ln(jnp.asarray(x), jnp.asarray(ln_s), jnp.asarray(ln_b), EPS)
    if static:
        want = np.asarray(jq._quant_static(h))
        assert s is None
    else:
        wq, ws = jq._quant_rows(h)
        want = np.asarray(wq)
        ws = np.asarray(ws)[:, 0]
        # the quantization alone, on JAX's LN output: the same bits
        hq, hs = tq._quant_rows(torch.from_numpy(np.array(h)))
        np.testing.assert_array_equal(hq.numpy(), want)
        np.testing.assert_array_equal(hs.numpy(), ws)
        ours = tq._ln(torch.from_numpy(x), torch.from_numpy(ln_s),
                      torch.from_numpy(ln_b), EPS).abs().amax(-1)
        amax_ulps = _ulps(ours.numpy(), np.abs(np.asarray(h)).max(-1))
        assert _ulps(s.numpy(), ws) <= amax_ulps + 1
        if amax127:
            assert (ws == 1.0).all() and (s.numpy() == 1.0).all()
    np.testing.assert_array_equal(q.numpy(), want)
    if ties:  # the planted ties rounded half to even
        half = np.array([0, 2, 2, 0, -2, -2, 4, -4], np.int8)
        if static or amax127:
            assert (q.numpy()[:, 1:9] == half).all()


def _node(rng, k, n):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    q, s = tq.quantize_weight_int8(torch.from_numpy(w))
    b = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    return QDense(q, s, b)


MODES = (("qkv", tfb.ACT_NONE, False, None),
         ("qkv,static", tfb.ACT_NONE, True, None),
         ("qkv codes,static", tfb.ACT_NONE, True, 1.0),
         ("fc1,gelu_tanh", tfb.ACT_GELU_TANH, False, None),
         ("fc1,gelu_erf", tfb.ACT_GELU_ERF, False, None),
         ("fc1,gelu_tanh,static", tfb.ACT_GELU_TANH, True, 0.7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_split_plain_matches_one_piece(mode, dtype):
    """`_gemm_i8_ref` on `ln_quant_rows`'s codes and the K-major weights
    equals `_ln_gemm_i8_ref` (the wrapper's CPU path) bit for bit."""
    _, act, static, a_inv = mode
    rng = np.random.default_rng(20)
    k, n = 256, 384
    x = torch.from_numpy(_x(rng, 131, k)).to(dtype)
    ln_s, ln_b = (torch.from_numpy(v) for v in _ln_vectors(rng, k, True,
                                                           False))
    if static:
        ln_s, ln_b = ln_s * 20.0, ln_b * 20.0
    nd = _node(rng, k, n)
    ai = None if a_inv is None else torch.full((1, 1), a_inv)
    hq, hs = tq.ln_quant_rows(x, ln_s, ln_b, EPS, static)
    split = tq._gemm_i8_ref(hq, hs, nd.q8t, nd.scale, nd.bias, act, x.dtype,
                            static, ai)
    one = tq._ln_gemm_i8_ref(x, ln_s, ln_b, nd.q8, nd.scale, nd.bias, act,
                             EPS, static, ai)
    wrapper = tq.ln_gemm_i8(x, ln_s, ln_b, nd.q8, nd.scale, nd.bias, act,
                            EPS, static, ai, q8t=nd.q8t)
    assert split.dtype == one.dtype and torch.equal(split, one)
    assert torch.equal(wrapper, one)


@pytest.mark.parametrize("static", [False, True])
def test_split_plain_matches_one_piece_gated(static):
    rng = np.random.default_rng(21 + static)
    k, f = 256, 192
    x = torch.from_numpy(_x(rng, 131, k))
    ln_s, ln_b = (torch.from_numpy(v) for v in _ln_vectors(rng, k, True,
                                                           False))
    if static:
        ln_s, ln_b = ln_s * 20.0, ln_b * 20.0
    nd = _node(rng, k, 2 * f)
    ai = torch.full((1, 1), 0.3) if static else None
    hq, hs = tq.ln_quant_rows(x, ln_s, ln_b, EPS, static)
    split = tq._gemm_i8_swiglu_ref(hq, hs, nd.q8t, nd.scale, nd.bias,
                                   x.dtype, static, ai)
    one = tq._ln_gemm_i8_swiglu_ref(x, ln_s, ln_b, nd.q8, nd.scale, nd.bias,
                                    EPS, static, ai)
    assert split.shape == (131, f) and torch.equal(split, one)
    assert split.dtype == (torch.int8 if static else torch.float32)


def _check_kmajor(model) -> int:
    nodes = [m for m in model.modules() if isinstance(m, QDense)]
    for m in nodes:
        assert m.q8t.dtype == torch.int8 and m.q8t.is_contiguous()
        assert torch.equal(m.q8t, m.q8.t())
        assert "q8t" not in m.state_dict()
    return len(nodes)


KINDS = {"dinov2": dict(model_size="tiny", patch_size=14, fusion_heads=4),
         "gated_tiny128": dict(model_size="tiny128", ffn_layer="swiglu",
                               patch_size=14, fusion_heads=4)}


@pytest.mark.parametrize("quantize_last", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_every_quantized_dense_holds_its_kmajor_form(kind, static,
                                                     quantize_last):
    torch.manual_seed(3)
    model = DinoSliceClassifier(out_ch=2, **KINDS[kind]).eval()
    calib = (np.random.default_rng(4).standard_normal((1, 1, 2, 28, 28))
             .astype(np.float32) if static else None)
    qm = tq.quantize_mst_int8(model, calib, dtype=torch.float32,
                              quantize_last=quantize_last)
    depth = model.encoder.depth
    blocks = depth if quantize_last else depth - 1
    assert _check_kmajor(qm) == 4 * blocks
    if kind == "gated_tiny128":
        w12 = qm.encoder.blocks_0.mlp.w12
        assert w12.q8t.shape == (w12.q8.shape[1], w12.q8.shape[0])
    # carried across: the same tree's leaves through `quantized_from_flax`
    flat = {k.replace(".", "/"): v.numpy()
            for k, v in qm.state_dict().items()}
    carried = quantized_from_flax(model, flat)
    assert _check_kmajor(carried) == 4 * blocks


# -- launch geometry ----------------------------------------------------------


def _constants(name):
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
    return {k: int(v) for k, v in re.findall(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text)}


def test_geometry_mirrors_the_sources():
    c, h = _constants("ln_gemm_i8.cu"), _constants("gemm_sm90.cuh")
    assert h["BK8"] == tq.I8_BK and h["KSTEPS"] * 32 == tq.I8_BK
    assert (c["QR_ROWS"], c["QR_MAX_K"]) == (tq._QR_ROWS, tq.I8_MAX_K)
    modes = re.search(r"enum OutMode : int \{([^}]*)\}",
                      (_build.CSRC / "ln_gemm_i8.cu").read_text()).group(1)
    assert [s.split("=")[1].strip() for s in modes.split(",")] == [
        str(v) for v in (tq.OUT_BF16, tq.OUT_F32, tq.OUT_I8)]


@pytest.mark.parametrize("k", range(128, tq.I8_MAX_K + 1, 128))
def test_geometry_at_every_width(k):
    for m in ROWS:
        for n, gated in ((128, False), (1152, False), (64, True),
                         (4096, True)):
            geo = tq.ln_gemm_i8_launch(m, k, n, gated)
            per_tile = 64 if gated else 128
            assert geo.tiles == -(-m // 128) * (n // per_tile)
            assert geo.grid == min(geo.tiles, 132)
            assert geo.k_tiles * 128 == k
            assert geo.second_box == (n if gated else 64)
            assert geo.quant_blocks * 8 >= m > (geo.quant_blocks - 1) * 8
            assert geo.threads == 288 and geo.smem <= SMEM_LIMIT
            assert geo.smem == tfb.GEMM_SMEM


@pytest.mark.parametrize("k,n,gated", PATH)
def test_gated_boxes_cover_w12_once(k, n, gated):
    """A tile's two 64-row boxes of W^T: rows [c0, c0 + 64) and [c1, c1 +
    64) with c0 = 64 t, c1 = F + 64 t (gated: h1 and h2 of gate columns
    64 t ..) or c1 = c0 + 64 (a 128-column tile); over the tiles of a row
    every W^T row is read once."""
    geo = tq.ln_gemm_i8_launch(8 * 32 * 257, k, n, gated)
    tiles_n = n // (64 if gated else 128)
    rows = []
    for t in range(tiles_n):
        c0 = t * (64 if gated else 128)
        c1 = n + c0 if gated else c0 + 64
        if t == 0:
            assert c1 == geo.second_box
        rows += [*range(c0, c0 + 64), *range(c1, c1 + 64)]
    assert sorted(rows) == list(range(2 * n if gated else n))


@pytest.mark.parametrize("m,k,n,gated,what", [
    (64, 320, 384, False, "K % 128"), (64, 4224, 384, False, "K <= 4096"),
    (64, 384, 192, False, "N % 128"), (0, 384, 384, False, "M >= 1"),
    (64, 384, 96, True, "F % 64"), (64, 448, 128, True, "K % 128")])
def test_wrappers_refuse_shapes_before_any_launch(monkeypatch, m, k, n,
                                                  gated, what):
    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    w = 2 * n if gated else n
    q8, q8t = (torch.zeros((k, w), dtype=torch.int8),
               torch.zeros((w, k), dtype=torch.int8))
    vec = torch.zeros(w)
    with pytest.raises(ValueError, match="needs M >= 1, K % 128"):
        if gated:
            tq.ln_gemm_i8_swiglu(x, torch.ones(k), torch.zeros(k), q8, vec,
                                 vec, EPS, q8t=q8t)
        else:
            tq.ln_gemm_i8(x, torch.ones(k), torch.zeros(k), q8, vec, vec,
                          tfb.ACT_NONE, EPS, q8t=q8t)
    with pytest.raises(ValueError):
        tq.ln_gemm_i8_launch(m, k, n, gated)


def _no_library():
    raise AssertionError("the kernel library was reached")


def test_wrappers_need_the_kmajor_form(monkeypatch):
    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    k, n = 384, 1152
    x = torch.zeros((771, k), dtype=torch.bfloat16)
    q8, vec = torch.zeros((k, n), dtype=torch.int8), torch.zeros(n)
    with pytest.raises(ValueError, match="needs q8t"):
        tq.ln_gemm_i8(x, torch.ones(k), torch.zeros(k), q8, vec, vec,
                      tfb.ACT_NONE, EPS)
    with pytest.raises(ValueError, match="q8t has shape"):
        tq.ln_gemm_i8(x, torch.ones(k), torch.zeros(k), q8, vec, vec,
                      tfb.ACT_NONE, EPS, q8t=q8)
    with pytest.raises(TypeError, match="q8t must be int8"):
        tq.ln_gemm_i8(x, torch.ones(k), torch.zeros(k), q8, vec, vec,
                      tfb.ACT_NONE, EPS, q8t=q8.t().float())
    with pytest.raises(ValueError, match="ln_quant_rows needs"):
        tq.ln_quant_rows(torch.zeros((4, 12), dtype=torch.bfloat16),
                         torch.ones(12), torch.zeros(12), EPS)


@pytest.mark.parametrize("gated", [False, True])
def test_wrappers_accept_kernel_shapes(monkeypatch, gated):
    """A shape the kernels take passes the checks and reaches the library
    (a stand-in that stops the call) at `ln_quant_rows`, the first
    launch."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    k, n = 1536, 4096 if gated else 4608
    w = 2 * n if gated else n
    x = torch.zeros((771, k), dtype=torch.bfloat16)
    q8, q8t = (torch.zeros((k, w), dtype=torch.int8),
               torch.zeros((w, k), dtype=torch.int8))
    vec = torch.zeros(w)
    with pytest.raises(Reached):
        if gated:
            tq.ln_gemm_i8_swiglu(x, torch.ones(k), torch.zeros(k), q8, vec,
                                 vec, EPS, static=True,
                                 a_inv=torch.ones(1, 1), q8t=q8t)
        else:
            tq.ln_gemm_i8(x, torch.ones(k), torch.zeros(k), q8, vec, vec,
                          tfb.ACT_NONE, EPS, q8t=q8t)


def test_sources_are_wgmma_and_built():
    """`ln_gemm_i8.cu` runs its product on the int8 wgmma of the shared
    mainloop: no WMMA / mma.sync left, every entry point bound, the old
    one-kernel entries gone."""
    text = (_build.CSRC / "ln_gemm_i8.cu").read_text()
    assert "wmma" not in text and "mma_sync" not in text
    assert '#include "gemm_sm90.cuh"' in text
    assert "m64n128k32.s32.s8.s8" in (_build.CSRC / "gemm_sm90.cuh").read_text()
    for sym in ("mst_ln_quant_rows", "mst_gemm_i8", "mst_gemm_i8_swiglu",
                "mst_gemm_i8_geometry", "mst_gemm_i8_probe"):
        assert sym in _build._SIGNATURES
        assert f"int {sym}(" in text
    assert "mst_ln_gemm_i8" not in _build._SIGNATURES
    assert "mst_ln_gemm_i8_swiglu" not in _build._SIGNATURES
