"""`gemm_dgrad` and `gemm_wgrad` on the TMA + wgmma GEMM of
`mst_tpu_torch/csrc/gemm_sm90.cuh` (`gemm_dgrad.cu`, `gemm_wgrad.cu`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them. The launch geometry the wrappers and the card-side checks
read (`gemm_dgrad_launch`, `gemm_wgrad_launch`) at every model width and
row count: every reduction row in exactly one chunk, no accumulation chain
longer than `_WGRAD_MAX_ROWS`, shared memory within a block's 227 KB, the
workspace the kernel asks for; its constants against the headers; the
fixed-order split sum of the plain arithmetic against the unsplit f64
product; the LN pullback at K = 384, which now takes the f32 product and
`ln_pullback` as every width does, against JAX's `_ln_bwd` plus the
residual; the wrappers' shape refusals before any launch; the sources in
the build's hash. `chip_smoke.py` phases 2 and 41 hold the same geometry to
the kernels' own export and the kernels to their plain versions on the
card."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.models.vit import _VIT_CONFIGS, VisionTransformer
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
WIDTHS = (384, 768, 1024, 1536)  # ViT-S / B / L, giant2
GATE_F = 4096  # giant2's SwiGLU gate width
ROWS = [b * 32 * s for b in (8, 2, 1) for s in (257, 201, 442)]


def _products(e):
    """(K, N) of every weight grad a^T [K, M] @ b [M, N] of one block at
    width e: proj, qkv, fc2, fc1; giant2's w3 and w12 beside its attention
    ones."""
    shapes = [(e, e), (e, 3 * e)]
    if e == WIDTHS[-1]:
        return shapes + [(GATE_F, e), (e, 2 * GATE_F)]
    return shapes + [(4 * e, e), (e, 4 * e)]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("e", WIDTHS)
def test_wgrad_geometry_covers_every_row_once(e, m):
    for k, n in _products(e):
        geo = tfb.gemm_wgrad_launch(m, k, n)
        tiles = (k // 128) * (n // 128)
        assert geo.rows % 64 == 0 and 0 < geo.rows <= tfb._WGRAD_MAX_ROWS
        # the chunks [s * rows, (s + 1) * rows) cover 0..m-1, each row once
        assert (geo.splits - 1) * geo.rows < m <= geo.splits * geo.rows
        assert geo.units == tiles * geo.splits
        assert geo.grid == min(geo.units, 132)
        assert geo.smem <= SMEM_LIMIT and geo.threads == 288
        assert geo.workspace == 4 * ((geo.splits * k * n if geo.splits > 1
                                      else 0) + 2 * geo.splits * n)
        # whole waves of the card, or the fewest splits the chain needs
        need = -(-m // tfb._WGRAD_MAX_ROWS)
        assert geo.splits >= need
        if geo.splits > need:
            assert geo.units <= -(-need * tiles // 132) * 132


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("e", WIDTHS)
def test_dgrad_geometry_covers_every_tile_once(e, m):
    for k, r in _products(e):  # dy [m, r] @ w [k, r]^T -> [m, k]
        geo = tfb.gemm_dgrad_launch(m, r, k)
        assert geo.units == -(-m // 128) * (k // 128)
        assert geo.splits == 1 and geo.rows == r and geo.workspace == 0
        assert geo.grid == min(geo.units, 132)
        assert geo.smem <= SMEM_LIMIT and geo.threads == 288


@pytest.mark.parametrize("size", ["small", "base", "large", "giant2"])
def test_every_model_product_has_a_launch(size):
    """The encoders' own weights give the shapes above: each backward
    product of a block is one the kernels take."""
    with torch.device("meta"):
        block = VisionTransformer(**_VIT_CONFIGS[size]).blocks_0
    kernels = [block.attn.qkv.kernel, block.attn.proj.kernel]
    if block.ffn_layer == "swiglu":
        kernels += [block.mlp.w12.kernel, block.mlp.w3.kernel]
    else:
        kernels += [block.mlp.fc1.kernel, block.mlp.fc2.kernel]
    m = 8 * 32 * 257
    for w in kernels:
        k_in, n_out = w.shape
        tfb.gemm_wgrad_launch(m, k_in, n_out)  # dW = x^T dy
        tfb.gemm_dgrad_launch(m, n_out, k_in)  # dx = dy W^T


def _header_constants(name):
    """The `constexpr` ints of a header, evaluated in order as the compiler
    would (integer division, size_t as int)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
    env = {}
    for key, expr in re.findall(
            r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
        expr = expr.replace("size_t(", "int(").replace("/", "//")
        env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def test_launch_geometry_mirrors_the_headers():
    c = _header_constants("gemm_sm90.cuh")
    assert tfb.GEMM_SMEM == c["SMEM_BYTES"] <= SMEM_LIMIT
    assert (c["BM"], c["BN"], c["BK"], c["STAGES"], c["THREADS"]) == (
        tfb.GEMM_BM, tfb.GEMM_BN, tfb.GEMM_BK, tfb.GEMM_STAGES,
        tfb.GEMM_THREADS)
    wgrad = (_build.CSRC / "gemm_wgrad.cu").read_text()
    assert re.search(r"constexpr int MAX_ROWS = (\d+);", wgrad).group(1) == \
        str(tfb._WGRAD_MAX_ROWS)
    # the f32 staging of the backward epilogues fits the bf16 tile's room
    assert 64 * c["EPI_LD_F"] * 4 == c["EPI_BYTES"]
    modes = re.search(r"enum Mode : int \{([^}]*)\}",
                      (_build.CSRC / "gemm_dgrad.cu").read_text()).group(1)
    assert [s.split("=")[1].strip() for s in modes.split(",")] == [
        str(v) for v in (tfb._DGRAD_PLAIN, tfb._DGRAD_GELU, tfb._DGRAD_SWIGLU,
                         tfb._DGRAD_F32)]


def _split_sum(a, b, rows):
    """a^T @ b and b's column sums as the kernel orders them: one f32 sum
    per chunk of `rows` rows, then the chunks added as
    `sum_partials_kernel` adds them (8 strided lanes, then the lanes in
    order), all in f32."""
    m = a.shape[0]
    parts = [a[s:s + rows].T.astype(np.float32) @ b[s:s + rows]
             for s in range(0, m, rows)]
    cols = [b[s:s + rows].sum(0, dtype=np.float32) for s in range(0, m, rows)]

    def fixed_order(ps):
        lanes = [np.zeros_like(ps[0]) for _ in range(8)]
        for i, p in enumerate(ps):
            lanes[i % 8] = lanes[i % 8] + p
        out = np.zeros_like(ps[0])
        for lane in lanes:
            out = out + lane
        return out
    return fixed_order(parts), fixed_order(cols)


@pytest.mark.parametrize("m,k,n", [(4112, 128, 256), (771, 256, 128),
                                   (20_000, 128, 128)])
def test_split_order_sum_matches_the_unsplit_f64_product(m, k, n):
    """The fixed-order sum of per-chunk f32 partials (the kernel's order at
    a small card of 8 SMs, so that the rows split) lies within f32 rounding
    of the unsplit f64 product."""
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    geo = tfb.gemm_wgrad_launch(m, k, n, sms=8)
    assert geo.splits > 1
    dw, db = _split_sum(a, b, geo.rows)
    want_w = a.astype(np.float64).T @ b.astype(np.float64)
    want_b = b.astype(np.float64).sum(0)
    # f32 rounding: a few 1e-6 of the largest sum (the card holds the
    # kernel to its plain version within 2e-5 of it)
    sw, sb = 5e-6 * np.abs(want_w).max(), 5e-6 * np.abs(want_b).max()
    np.testing.assert_allclose(dw, want_w, atol=sw, rtol=0)
    np.testing.assert_allclose(db, want_b, atol=sb, rtol=0)
    # and so does the plain version the kernel is held to on the card
    pw, pb = tfb._gemm_wgrad_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(pw.numpy(), want_w, atol=sw, rtol=0)
    np.testing.assert_allclose(pb.numpy(), want_b, atol=sb, rtol=0)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_ln_route_at_384_matches_mst_tpu_ln_bwd(eps):
    """At K = 384 (ViT-S, DINOv3) the LN pullback now takes the f32 product
    and `ln_pullback` as every width does: on the CPU `gemm_dgrad(...,
    ln=...)` is `_ln_pullback_ref` of the f32 product, which matches JAX's
    `_ln_bwd` plus the residual."""
    rng = np.random.default_rng(11)
    m, r, k = 20, 3 * 384, 384
    # dh = dy @ w^T of O(1), as the product of an upstream grad and a
    # weight scaled by its fan-in (the f32 sums run in another order in JAX)
    dy = torch.from_numpy(rng.standard_normal((m, r)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, r)) / np.sqrt(r)).astype(
        np.float32))
    x, g = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
            for _ in range(2))
    ln_s = torch.from_numpy((1 + 0.1 * rng.standard_normal(k)).astype(
        np.float32))
    ln = (x, g, ln_s, eps)
    route = tfb.gemm_dgrad(dy, w, ln=ln)
    pullback = tfb.ln_pullback(tfb._mm(dy, w.t()), *ln)
    for a, b in zip(route, pullback):
        assert torch.equal(a, b)
    xhat, rstd = jfb._ln_recompute(jnp.asarray(x.numpy())[None],
                                   jnp.asarray(ln_s.numpy()), eps)
    jdx, jdlns, jdlnb = jfb._ln_bwd(jnp.asarray((dy @ w.t()).numpy())[None],
                                    xhat, rstd, jnp.asarray(ln_s.numpy()))
    for a, b in zip(route, (jdx[0] + jnp.asarray(g.numpy()), jdlns, jdlnb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _no_library():
    raise AssertionError("the kernel library was reached")


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("m,r,k,what", [
    (64, 96, 384, "R % 64"), (64, 384, 192, "K % 128"),
    (0, 384, 384, "M >= 1"), (64, 32, 128, "R % 64")])
def test_dgrad_refuses_shapes_before_any_launch(monkeypatch, m, r, k, what):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError, match="gemm_dgrad needs"):
        tfb.gemm_dgrad(_bf(m, r), _bf(k, r))


def test_dgrad_refuses_a_wide_or_misshapen_ln_before_any_launch(monkeypatch):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    m, r = 64, 128
    lns = torch.ones(2048)
    with pytest.raises(ValueError, match="K <= 1536"):
        tfb.gemm_dgrad(_bf(m, r), _bf(2048, r),
                       ln=(_bf(m, 2048), _bf(m, 2048), lns, 1e-6))
    with pytest.raises(ValueError, match="x has shape"):
        tfb.gemm_dgrad(_bf(m, r), _bf(384, r),
                       ln=(_bf(m - 1, 384), _bf(m, 384), lns[:384], 1e-6))
    with pytest.raises(ValueError, match="h12 has shape"):
        tfb.gemm_dgrad(_bf(m, r), _bf(384, r), a=_bf(m, 384),
                       act=tfb.ACT_SWIGLU)


@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (64, 128, 192),
                                   (0, 128, 128), (64, 384, 96)])
def test_wgrad_refuses_shapes_before_any_launch(monkeypatch, m, k, n):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    monkeypatch.setattr(tfb, "_sms", _no_library)
    with pytest.raises(ValueError, match="gemm_wgrad needs"):
        tfb.gemm_wgrad(_bf(m, k), _bf(m, n))


@pytest.mark.parametrize("kind", ["wgrad", "plain", "gelu", "swiglu", "ln"])
def test_wrappers_accept_kernel_shapes(monkeypatch, kind):
    """A shape the kernels take passes the checks and reaches the library
    (here a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tfb, "_sms", lambda t: 132)
    monkeypatch.setattr(_build, "lib", stand_in)
    m, r, k = 771, 384, 256
    dy, w = _bf(m, r), _bf(k, r)
    with pytest.raises(Reached):
        if kind == "wgrad":
            tfb.gemm_wgrad(_bf(m, k), dy)
        elif kind == "plain":
            tfb.gemm_dgrad(dy, w)
        elif kind == "gelu":
            tfb.gemm_dgrad(dy, w, a=_bf(m, k), act=tfb.ACT_GELU_TANH)
        elif kind == "swiglu":
            tfb.gemm_dgrad(dy, w, a=_bf(m, 2 * k), act=tfb.ACT_SWIGLU)
        else:
            tfb.gemm_dgrad(dy, w, ln=(_bf(m, k), _bf(m, k), torch.ones(k),
                                      1e-6))


def test_sources_are_built_and_hashed(monkeypatch, tmp_path):
    """The backward GEMMs' sources, their header and the layout probes are
    in the build, each named in the library's hash, and no WMMA is left in
    the two GEMMs."""
    names = {p.name for p in _build._sources()}
    assert {"gemm_dgrad.cu", "gemm_wgrad.cu", "gemm_sm90.cuh"} <= names
    for src in ("gemm_dgrad.cu", "gemm_wgrad.cu"):
        text = (_build.CSRC / src).read_text()
        assert "wmma::" not in text and "mma_sync" not in text
        assert '#include "gemm_sm90.cuh"' in text
    for sym, src in (("mst_gemm_dgrad", "gemm_dgrad.cu"),
                     ("mst_dgrad_geometry", "gemm_dgrad.cu"),
                     ("mst_ln_pullback", "gemm_dgrad.cu"),
                     ("mst_gemm_wgrad", "gemm_wgrad.cu"),
                     ("mst_wgrad_geometry", "gemm_wgrad.cu"),
                     ("mst_gemm_probe", "gemm_wgrad.cu")):
        assert sym in _build._SIGNATURES
        assert f"int {sym}(" in (_build.CSRC / src).read_text()
    assert "mst_gemm_dgrad_f32" not in _build._SIGNATURES
    # a change to the shared header changes the library's name
    copy = tmp_path / "csrc"
    copy.mkdir()
    for p in _build._sources():
        (copy / p.name).write_bytes(p.read_bytes())
    before = _build.library_path()
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path() == before
    header = copy / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert _build.library_path() != before
