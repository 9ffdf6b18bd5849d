"""`ln_gemm` / `ln_gemm_swiglu` as two kernels on the card: `ln_rows` (LN
once per row) then a TMA + wgmma GEMM on the normalised rows
(`mst_tpu_torch/csrc/ln_gemm.cu`, `gemm_sm90.cuh`).

On the CPU the wrappers take the plain versions, which are now the
composition of the two halves (`_ln_rows_ref`, then `_gemm_act_ref` /
`_gemm_swiglu_ref`). These tests hold that composition to the one-piece
formulas it replaced, bit for bit, and to `mst_tpu`'s LN and products in
f32; they check the launch geometry the kernel uses against the header
it is built from and every width the models have, and that the wrappers refuse the shapes the kernel does
not take before anything is launched."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.models.vit import _VIT_CONFIGS, VisionTransformer
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb

M = 37  # rows: not a multiple of any tile
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
MODES = ("none", "gelu_tanh", "gelu_erf", "train_none", "train_gelu_tanh",
         "train_gelu_erf", "gated", "gated_train")
ACTS = {"none": tfb.ACT_NONE, "gelu_tanh": tfb.ACT_GELU_TANH,
        "gelu_erf": tfb.ACT_GELU_ERF}


def _inputs(seed, k, n, dtype):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x, ln_s, ln_b = r(M, k, off=0.3), r(k, scale=0.1, off=1.0), r(k, scale=0.1)
    w, b = r(k, n, scale=k ** -0.5), r(n, scale=0.1)
    t = torch.from_numpy
    return (t(x).to(dtype), t(ln_s), t(ln_b), t(w).to(dtype), t(b))


# The plain versions as they stood before the split (one function each),
# kept here to hold the composition of the two halves to them.
def _one_piece_ln_gemm(x, ln_s, ln_b, w, b, act, eps, train=False):
    h = tfb._ln(x, ln_s, ln_b, eps).to(x.dtype)
    y = tfb._mm(h, w) + tfb._f(b)
    if train:
        pre = y.to(x.dtype)
        post = None if act == tfb.ACT_NONE else tfb._gelu(
            tfb._f(pre), act == tfb.ACT_GELU_TANH).to(x.dtype)
        return pre, h, post
    if act != tfb.ACT_NONE:
        y = tfb._gelu(y, act == tfb.ACT_GELU_TANH)
    return y.to(x.dtype)


def _one_piece_ln_gemm_swiglu(x, ln_s, ln_b, w12, b12, eps, train=False):
    h = tfb._ln(x, ln_s, ln_b, eps).to(x.dtype)
    h12 = tfb._mm(h, w12) + tfb._f(b12)
    if train:
        h12 = h12.to(x.dtype)
    h1, h2 = tfb._f(h12).chunk(2, dim=-1)
    g = (h1 * torch.sigmoid(h1) * h2).to(x.dtype)
    return (h12, h, g) if train else g


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [64, 128, 384])
@pytest.mark.parametrize("mode", MODES)
def test_split_plain_versions_equal_the_one_piece_formulas(mode, k, dtype):
    gated = mode.startswith("gated")
    train = "train" in mode
    x, ln_s, ln_b, w, b = _inputs(k, k, 2 * 64 if gated else 3 * k, dtype)
    eps = 1e-6
    h = tfb._ln_rows_ref(x, ln_s, ln_b, eps)
    if gated:
        halves = tfb._gemm_swiglu_ref(h, w, b, train=train)
        halves = (halves[0], h, halves[1]) if train else halves
        whole = tfb._ln_gemm_swiglu_ref(x, ln_s, ln_b, w, b, eps, train)
        ref = _one_piece_ln_gemm_swiglu(x, ln_s, ln_b, w, b, eps, train)
    else:
        act = ACTS[mode.removeprefix("train_")]
        halves = tfb._gemm_act_ref(h, w, b, act, train=train)
        halves = (halves[0], h, halves[1]) if train else halves
        whole = tfb._ln_gemm_ref(x, ln_s, ln_b, w, b, act, eps, train)
        ref = _one_piece_ln_gemm(x, ln_s, ln_b, w, b, act, eps, train)
    for got in (halves, whole):
        got, want = _as_tuple(got), _as_tuple(ref)
        assert len(got) == len(want)
        for g, r in zip(got, want):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.dtype == r.dtype == dtype
                assert torch.equal(g, r)
    # the CPU wrapper is the plain composition
    if gated:
        out = tfb.ln_gemm_swiglu(x, ln_s, ln_b, w, b, eps, train=train)
    else:
        out = tfb.ln_gemm(x, ln_s, ln_b, w, b, act, eps, train=train)
    for g, r in zip(_as_tuple(out), _as_tuple(ref)):
        assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_ln_rows_ref_matches_mst_tpu_ln(eps):
    x, ln_s, ln_b, _, _ = _inputs(1, 384, 128, torch.float32)
    got = tfb._ln_rows_ref(x, ln_s, ln_b, eps).numpy()
    want = jfb._ln(jnp.asarray(x.numpy()), jnp.asarray(ln_s.numpy()),
                   jnp.asarray(ln_b.numpy()), eps)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # and the wrapper on the CPU, which launches nothing
    tfb.reset_launch_counts()
    assert torch.equal(tfb.ln_rows(x, ln_s, ln_b, eps),
                       tfb._ln_rows_ref(x, ln_s, ln_b, eps))
    assert tfb.launch_counts()["ln_rows"] == 0


@pytest.mark.parametrize("mode", ["none", "gelu_tanh", "gelu_erf", "gated"])
def test_plain_halves_match_mst_tpu_products(mode):
    """LN, the product, bias and the GELU or SiLU gate of the Pallas bodies
    (`_ln` and the XLA compositions of mst_tpu.ops.fused_block) in f32."""
    k, f = 128, 64
    gated = mode == "gated"
    x, ln_s, ln_b, w, b = _inputs(2, k, 2 * f if gated else 4 * k,
                                  torch.float32)
    j = [jnp.asarray(t.numpy()) for t in (x, ln_s, ln_b, w, b)]
    hj = jfb._ln(j[0], j[1], j[2], 1e-6)
    yj = hj @ j[3] + j[4]
    if gated:
        h1, h2 = jnp.split(yj, 2, axis=-1)
        want = jax.nn.silu(h1) * h2
        got = tfb.ln_gemm_swiglu(x, ln_s, ln_b, w, b, 1e-6)
    else:
        want = (yj if mode == "none" else
                jax.nn.gelu(yj, approximate=mode == "gelu_tanh"))
        got = tfb.ln_gemm(x, ln_s, ln_b, w, b, ACTS[mode], 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _path_widths(size):
    """(K, N, gated) of the two `ln_gemm` GEMMs of one block of the encoder
    at `size` (built on the meta device): qkv, then fc1 or the gated w12
    (N = F, the gate width)."""
    with torch.device("meta"):
        block = VisionTransformer(**_VIT_CONFIGS[size]).blocks_0
    qkv = block.attn.qkv.kernel.shape
    gated = block.ffn_layer == "swiglu"
    ffn = (block.mlp.w12 if gated else block.mlp.fc1).kernel.shape
    return [(qkv[0], qkv[1], False),
            (ffn[0], ffn[1] // 2 if gated else ffn[1], gated)]


@pytest.mark.parametrize("size", sorted(_VIT_CONFIGS))
def test_launch_geometry_fits_every_model_width(size):
    m = 8 * 32 * 257  # B=8 of 32 slices, 257 tokens
    for k, n, gated in _path_widths(size):
        bn = 64 if gated else 128
        if k % 64 or n % bn:
            # the test-only widths the card does not take (tiny: E = 32)
            assert size.startswith("tiny")
            with pytest.raises(ValueError):
                tfb.ln_gemm_launch(m, k, n, gated)
            continue
        geo = tfb.ln_gemm_launch(m, k, n, gated)
        assert geo.smem <= SMEM_LIMIT
        assert geo.threads == 288 and 4 <= geo.stages <= 5
        assert geo.tiles == -(-m // 128) * (n // bn)
        assert geo.grid == min(geo.tiles, 132)
    if size == "giant2":  # the shapes of the chip's timings
        assert _path_widths(size) == [(1536, 4608, False), (1536, 4096, True)]
    # one row still makes one tile per column panel
    assert tfb.ln_gemm_launch(1, 1536, 4096, gated=True).tiles == 64


@pytest.mark.parametrize("sms", [132, 114])
def test_launch_geometry_follows_the_sm_count(sms):
    """The persistent grid is one CTA per SM of the card it runs on (the
    kernel asks the device, `persistent_grid`): an H100 PCIe has 114; only
    the grid moves with it."""
    for m in (8 * 32 * 257, 771, 1):
        for k, n, gated in [(384, 1152, False), (1536, 4096, True)]:
            geo = tfb.ln_gemm_launch(m, k, n, gated, sms)
            ref = tfb.ln_gemm_launch(m, k, n, gated)
            assert geo.grid == min(geo.tiles, sms)
            assert (geo.tiles, geo.threads, geo.stages, geo.smem) == (
                ref.tiles, ref.threads, ref.stages, ref.smem)
    assert tfb.ln_gemm_launch(8 * 32 * 257, 384, 1152, sms=sms).grid == sms


def _header_constants():
    """The `constexpr` values of csrc/gemm_sm90.cuh, evaluated in order as
    the compiler would (integer division, size_t as int)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "gemm_sm90.cuh").read_text())
    env = {}
    for name, expr in re.findall(
            r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
        expr = expr.replace("size_t(", "int(").replace("/", "//")
        env[name] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def test_launch_geometry_mirrors_the_header():
    """`ln_gemm_launch`'s constants and shared-memory formula are those of
    the header the kernel is built from (the card checks the whole
    geometry against the kernel's `mst_gemm_geometry` export)."""
    c = _header_constants()
    assert (c["BM"], c["BN"], c["BK"]) == (tfb.GEMM_BM, tfb.GEMM_BN,
                                           tfb.GEMM_BK)
    assert (c["STAGES"], c["THREADS"]) == (tfb.GEMM_STAGES, tfb.GEMM_THREADS)
    for k, n, gated in [(384, 1152, False), (1536, 4096, True)]:
        geo = tfb.ln_gemm_launch(771, k, n, gated)
        assert geo.smem == c["SMEM_BYTES"] <= SMEM_LIMIT
        assert geo.threads == c["THREADS"] and geo.stages == c["STAGES"]
    cu = (_build.CSRC / "ln_gemm.cu").read_text()
    assert "extern \"C\" int mst_gemm_geometry(" in cu
    assert "mst_gemm_geometry" in _build._SIGNATURES


@pytest.mark.parametrize("k,n,gated", [(96, 384, False), (32, 128, False),
                                       (128, 192, False), (128, 96, True),
                                       (64, 0, False)])
def test_wrappers_refuse_shapes_before_any_launch(monkeypatch, k, n, gated):
    """On a CUDA tensor the wrapper checks K % 64 and N % BN (F % 64 for the
    gated form) before it builds or launches anything: here `_on_cuda` is
    forced on for CPU tensors and the kernel library may not be reached."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", no_library)
    x, ln_s, ln_b, w, b = _inputs(3, k, 2 * n if gated else n,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="K % 64 == 0"):
        if gated:
            tfb.ln_gemm_swiglu(x, ln_s, ln_b, w, b, 1e-6)
        else:
            tfb.ln_gemm(x, ln_s, ln_b, w, b, tfb.ACT_NONE, 1e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_wrappers_accept_kernel_shapes(monkeypatch, gated):
    """A shape the kernel takes passes the checks and reaches the library
    (here a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    x, ln_s, ln_b, w, b = _inputs(4, 128, 128 if gated else 256,
                                  torch.bfloat16)
    with pytest.raises(Reached):
        if gated:
            tfb.ln_gemm_swiglu(x, ln_s, ln_b, w, b, 1e-6)
        else:
            tfb.ln_gemm(x, ln_s, ln_b, w, b, tfb.ACT_GELU_TANH, 1e-6)


def test_gemm_header_is_built_and_hashed():
    names = {p.name for p in _build._sources()}
    assert {"ln_gemm.cu", "gemm_sm90.cuh", "common.cuh"} <= names
    text = (_build.CSRC / "ln_gemm.cu").read_text()
    assert "wmma::" not in text and '#include "gemm_sm90.cuh"' in text
    for sym in ("mst_ln_rows", "mst_gemm_act", "mst_gemm_swiglu",
                "mst_gemm_geometry"):
        assert sym in _build._SIGNATURES and f"int {sym}(" in text
