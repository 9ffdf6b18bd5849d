"""`gemm_residual` and `gemm_dls` on the TMA + wgmma GEMM of
`mst_tpu_torch/csrc/gemm_sm90.cuh` (`gemm_residual.cu`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them. The launch geometry the wrappers and the card-side checks
read (`gemm_residual_launch`) at every model width and row count: every
output tile in one work unit, shared memory within a block's 227 KB, one
row of `gemm_dls`'s partials per 64 rows; its constants against the
sources; the fixed order in which the kernel sums dls (each 64-row block's
shuffle tree, then `sum_partials_kernel`'s lanes) against the f64 sum; the
plain versions against `mst_tpu`'s sub-layers and `jax.grad`; the
wrappers' shape refusals before any launch, and their aligned copies of
vectors at an odd offset; the source in the build's hash. `chip_smoke.py`
phases 2 and 42 hold the same geometry to the kernels' own export and the
kernels to their plain versions on the card."""

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
from mst_tpu_torch.tools import _common

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)  # as tests/test_fused_block.py:111
WIDTHS = (384, 768, 1024, 1536)  # ViT-S / B / L, giant2
GATE_F = 4096  # giant2's SwiGLU gate width
# B=8 of 257 tokens, DINOv3's B=8 (S = 201), giant2's B=2, B=1, 3 x 257, 1
ROWS = (65_792, 51_456, 16_448, 8_224, 771, 1)


def _products(e):
    """(K, N) of the products that end in a residual at width e: proj and
    fc2, or giant2's proj and w3."""
    return [(e, e), (GATE_F if e == WIDTHS[-1] else 4 * e, e)]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("e", WIDTHS)
def test_geometry_covers_every_tile_once(e, m):
    for k, n in _products(e):
        geo = tfb.gemm_residual_launch(m, k, n)
        # one work unit per 128 x 128 output tile: the row tiles cover
        # 0..m-1, the rows past m masked
        row_tiles, rest = divmod(geo.tiles, n // 128)
        assert rest == 0 and (row_tiles - 1) * 128 < m <= row_tiles * 128
        assert geo.grid == min(geo.tiles, 132)
        assert geo.smem <= SMEM_LIMIT and geo.threads == 288
        assert geo.stages == 5
        # gemm_dls: one partial row per 64 rows, each row in one of them
        assert (geo.work_rows - 1) * 64 < m <= geo.work_rows * 64
        # a card of fewer SMs walks the same units on fewer CTAs
        assert tfb.gemm_residual_launch(m, k, n, sms=8).grid == min(
            geo.tiles, 8)


@pytest.mark.parametrize("size", ["small", "base", "large", "giant2"])
def test_every_model_product_has_a_launch(size):
    """The encoders' own weights give the shapes above: each product that
    ends in a residual (proj, fc2 / w3) is one the kernels take."""
    with torch.device("meta"):
        block = VisionTransformer(**_VIT_CONFIGS[size]).blocks_0
    out = (block.mlp.w3.kernel if block.ffn_layer == "swiglu"
           else block.mlp.fc2.kernel)
    for w in (block.attn.proj.kernel, out):
        k_in, n_out = w.shape
        assert (k_in, n_out) in _products(n_out)
        tfb.gemm_residual_launch(8 * 32 * 257, k_in, n_out)


def _constants(name):
    """The `constexpr` ints of a source, evaluated in order as the compiler
    would (integer division, size_t as int)."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
    env = {}
    for key, expr in re.findall(
            r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
        expr = expr.replace("size_t(", "int(").replace("/", "//")
        env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def test_launch_geometry_mirrors_the_sources():
    c = _constants("gemm_sm90.cuh")
    assert tfb.GEMM_SMEM == c["SMEM_BYTES"] <= SMEM_LIMIT
    assert (c["BM"], c["BN"], c["BK"], c["STAGES"], c["THREADS"]) == (
        tfb.GEMM_BM, tfb.GEMM_BN, tfb.GEMM_BK, tfb.GEMM_STAGES,
        tfb.GEMM_THREADS)
    src = (_build.CSRC / "gemm_residual.cu").read_text()
    # the shape rule the wrappers mirror, and the 64-row partials
    assert re.search(r"return M > 0 && K >= BK && N >= BN && K % BK == 0 "
                     r"&& N % BN == 0;", src)
    assert src.count("(M + 63) / 64") == 2
    assert re.search(r"tiles, grid, sm90::THREADS, sm90::STAGES,\s*"
                     r"static_cast<int>\(sm90::SMEM_BYTES\), \(M \+ 63\) / 64",
                     src)
    # the x / g slab fits the bf16 staging tile, and dls's 4 warp rows of
    # f32 partials fit it too
    assert 64 * c["EPI_LD"] * 2 == c["EPI_BYTES"] >= 4 * c["BN"] * 4
    assert c["EPI_LD"] * 2 % 16 == 0  # 16-byte cp.async rows


def _tree64(p):
    """Column sums of f32 [64, n] rows in the kernel's order: row r + 8
    added to row r (r < 8 of each warp's 16), then the 8 row pairs of a
    warp as the butterfly over lanes 4, 8 and 16 apart adds them, then the
    4 warps in order."""
    out = None
    for w in range(4):
        v = [p[16 * w + q] + p[16 * w + 8 + q] for q in range(8)]
        for o in (1, 2, 4):
            v = [v[q] + v[q ^ o] for q in range(8)]
        out = v[0] if out is None else out + v[0]
    return out


def _dls_fixed_order(g, z):
    """dls = sum_m g * z as the kernel and `sum_partials_kernel` order it:
    f32 products, zero rows past m up to the 128-row tile, one partial per
    64-row block, then 8 strided lanes and the lanes in order."""
    m, n = g.shape
    prod = np.zeros((-(-m // 128) * 128, n), np.float32)
    prod[:m] = g * z
    parts = [_tree64(prod[r:r + 64]) for r in range(0, -(-m // 64) * 64, 64)]
    lanes = [np.zeros(n, np.float32) for _ in range(8)]
    for i, p in enumerate(parts):
        lanes[i % 8] = lanes[i % 8] + p
    out = np.zeros(n, np.float32)
    for lane in lanes:
        out = out + lane
    return out


@pytest.mark.parametrize("m,k,n", [(771, 128, 128), (4112, 64, 256),
                                   (20_000, 128, 128), (1, 64, 128)])
def test_dls_fixed_order_sum_matches_the_f64_sum(m, k, n):
    """The kernel's fixed-order sum of g * (a @ w + b) lies within f32
    rounding of the f64 sum, and so does the plain version the kernel is
    held to on the card."""
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    z = (a @ w).astype(np.float32) + b
    got = _dls_fixed_order(g, z)
    want = (g.astype(np.float64) * (a.astype(np.float64) @ w + b)).sum(0)
    # f32 rounding: a few 1e-6 of the sum's scale, sqrt(m) |g| |z| (the
    # card holds the kernel to its plain version within 2e-5 of its largest)
    tol = 5e-6 * np.sqrt(m) * np.abs(z).max() * np.abs(g).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    _, dls = tfb._gemm_dls_ref(*map(torch.from_numpy, (a, w, b)),
                               torch.ones(n), torch.from_numpy(g))
    np.testing.assert_allclose(dls.numpy(), want, atol=tol, rtol=0)


def _inputs(seed, n, s, e, hidden, with_ls):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=r(n, s, e), ln_s=r(e, scale=0.1, off=1.0),
                ln_b=r(e, scale=0.1), w_in=r(e, hidden, scale=e ** -0.5),
                b_in=r(hidden, scale=0.1),
                w_out=r(hidden, e, scale=hidden ** -0.5), b_out=r(e, scale=0.1),
                ls=r(e, scale=0.1, off=1.0) if with_ls else None,
                g=r(n, s, e))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _mlp_head(p, approximate, eps):
    """gelu(LN(x) @ w1 + b1) as `mst_tpu`'s `_mlp_ref` forms it."""
    h = jfb._ln(_j(p["x"]), _j(p["ln_s"]), _j(p["ln_b"]), eps)
    return jax.nn.gelu(h @ _j(p["w_in"]) + _j(p["b_in"]),
                       approximate=approximate)


@pytest.mark.parametrize("with_ls", [True, False])
@pytest.mark.parametrize("approximate", [True, False])
def test_residual_ref_is_the_tail_of_mst_tpu_mlp_ref(approximate, with_ls):
    """x + ls * (h @ w2 + b2) on `mst_tpu`'s own hidden h equals its
    `_mlp_ref` (f32)."""
    n, s, e, f = 2, 9, 128, 512
    p = _inputs(1, n, s, e, f, with_ls)
    eps = 1e-6
    want = jfb._mlp_ref(_j(p["x"]), _j(p["ln_s"]), _j(p["ln_b"]),
                        _j(p["w_in"]), _j(p["b_in"]), _j(p["w_out"]),
                        _j(p["b_out"]), _j(p["ls"]), approximate, eps)
    h = _mlp_head(p, approximate, eps).reshape(n * s, f)
    got = tfb._gemm_residual_ref(_t(h), _t(p["w_out"]), _t(p["b_out"]),
                                 _t(p["ls"]), _t(p["x"]).reshape(n * s, e))
    np.testing.assert_allclose(got.reshape(n, s, e).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("with_ls", [True, False])
def test_residual_ref_is_the_tail_of_mst_tpu_attn_ref(with_ls):
    """The attention core's output o, read from `mst_tpu`'s `_attn_ref`
    with an identity projection (x + o, less x), through
    `_gemm_residual_ref` with the real projection equals `_attn_ref`
    (f32)."""
    n, s, e, heads = 2, 9, 128, 2
    p = _inputs(2, n, s, e, 3 * e, with_ls)
    common = (_j(p["x"]), _j(p["ln_s"]), _j(p["ln_b"]), _j(p["w_in"]),
              _j(p["b_in"]))
    o = jfb._attn_ref(*common, jnp.eye(e), jnp.zeros(e), None, heads) - \
        _j(p["x"])
    want = jfb._attn_ref(*common, _j(p["w_out"][:e]), _j(p["b_out"]),
                         _j(p["ls"]), heads)
    got = tfb._gemm_residual_ref(_t(o).reshape(n * s, e), _t(p["w_out"][:e]),
                                 _t(p["b_out"]), _t(p["ls"]),
                                 _t(p["x"]).reshape(n * s, e))
    np.testing.assert_allclose(got.reshape(n, s, e).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("approximate", [True, False])
def test_dls_ref_matches_jax_grad_of_mst_tpu_mlp_ref(approximate):
    """dls = sum_m g * (h @ w2 + b2) is jax.grad of <g, `_mlp_ref`> with
    respect to ls, and gz = g * ls is its grad with respect to the branch
    before the LayerScale (f32)."""
    n, s, e, f = 2, 9, 128, 512
    p = _inputs(3, n, s, e, f, True)
    eps = 1e-6

    def loss(ls):
        y = jfb._mlp_ref(_j(p["x"]), _j(p["ln_s"]), _j(p["ln_b"]),
                         _j(p["w_in"]), _j(p["b_in"]), _j(p["w_out"]),
                         _j(p["b_out"]), ls, approximate, eps)
        return jnp.sum(y * _j(p["g"]))

    want = jax.grad(loss)(_j(p["ls"]))
    h = _mlp_head(p, approximate, eps).reshape(n * s, f)
    g2 = _t(p["g"]).reshape(n * s, e)
    gz, dls = tfb._gemm_dls_ref(_t(h), _t(p["w_out"]), _t(p["b_out"]),
                                _t(p["ls"]), g2)
    np.testing.assert_allclose(dls.numpy(), np.asarray(want), **GRAD_TOL)
    np.testing.assert_allclose(gz.numpy(), (g2 * _t(p["ls"])).numpy(), **TOL)


def _no_library():
    raise AssertionError("the kernel library was reached")


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


REFUSED = [(64, 32, 384, "K % 64"), (64, 96, 384, "K % 64"),
           (64, 384, 192, "N % 128"), (64, 384, 64, "N % 128"),
           (0, 384, 384, "M >= 1")]


@pytest.mark.parametrize("m,k,n,what", REFUSED)
@pytest.mark.parametrize("kind", ["gemm_residual", "gemm_dls", "gemm"])
def test_wrappers_refuse_shapes_before_any_launch(monkeypatch, kind, m, k, n,
                                                  what):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_common, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    a, w, x = _bf(m, k), _bf(k, n), _bf(m, n)
    b = torch.zeros(n)
    with pytest.raises(ValueError, match=f"{kind} needs M >= 1, K % 64 == 0 "
                                         f"and N % 128 == 0"):
        if kind == "gemm_residual":
            tfb.gemm_residual(a, w, b, None, x)
        elif kind == "gemm_dls":
            tfb.gemm_dls(a, w, b, torch.ones(n), x)
        else:
            _common.gemm(a, w)
    with pytest.raises(ValueError, match="gemm_residual needs"):
        tfb.gemm_residual_launch(m, k, n)


@pytest.mark.parametrize("kind", ["residual", "residual_no_ls", "dls",
                                  "gemm"])
def test_wrappers_accept_kernel_shapes(monkeypatch, kind):
    """A shape the kernels take (a ragged M, K = 64) passes the checks and
    reaches the library (here a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_common, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    m, k, n = 771, 64, 256
    a, w, x, b = _bf(m, k), _bf(k, n), _bf(m, n), torch.zeros(n)
    with pytest.raises(Reached):
        if kind == "residual":
            tfb.gemm_residual(a, w, b, torch.ones(n), x)
        elif kind == "residual_no_ls":
            tfb.gemm_residual(a, w, b, None, x)
        elif kind == "dls":
            tfb.gemm_dls(a, w, b, torch.ones(n), x)
        else:
            _common.gemm(a, w)


@pytest.mark.parametrize("kind", ["residual", "residual_no_ls", "dls"])
def test_wrappers_pass_aligned_vectors(monkeypatch, kind):
    """bias and ls that are views at a 4-byte offset of one flat buffer (as
    `vector_to_parameters` makes) reach the kernels, which read them as
    float2, as 16-byte aligned copies of the same values."""
    class Reached(Exception):
        pass

    seen = {}

    class Lib:
        def __getattr__(self, entry):
            def call(*args):
                seen["bias"], seen["ls"] = args[2], args[3]
                raise Reached
            return call

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tfb, "_stream", lambda t: None)
    monkeypatch.setattr(_build, "lib", Lib)
    m, k, n = 771, 64, 256
    flat = torch.arange(2 * n + 1, dtype=torch.float32)
    b, ls = flat[1:n + 1], flat[n + 1:]
    assert b.data_ptr() % 8 and ls.data_ptr() % 16
    a, w, x = _bf(m, k), _bf(k, n), _bf(m, n)
    with pytest.raises(Reached):
        if kind == "residual":
            tfb.gemm_residual(a, w, b, ls, x)
        elif kind == "residual_no_ls":
            tfb.gemm_residual(a, w, b, None, x)
        else:
            tfb.gemm_dls(a, w, b, ls, x)
    assert seen["bias"] % 16 == 0
    assert seen["ls"] is None if kind == "residual_no_ls" else (
        seen["ls"] % 16 == 0)
    for v in (b, ls):
        got = tfb._vec(v, "v", n, x)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, v)


def test_source_is_built_and_hashed(monkeypatch, tmp_path):
    """`gemm_residual.cu` is in the build on the wgmma mainloop, with no
    WMMA left, each entry point bound, and named in the library's hash."""
    assert "gemm_residual.cu" in {p.name for p in _build._sources()}
    text = (_build.CSRC / "gemm_residual.cu").read_text()
    assert "wmma" not in text and "mma_sync" not in text
    assert '#include "gemm_sm90.cuh"' in text
    assert "consumer_tile(" in text and "producer(" in text
    # the Pallas bodies it replaces
    assert "mst_tpu/ops/fused_block.py" in text
    for sym in ("mst_gemm_residual", "mst_gemm_dls", "mst_residual_geometry"):
        assert sym in _build._SIGNATURES
        assert f"int {sym}(" in text
    copy = tmp_path / "csrc"
    copy.mkdir()
    for p in _build._sources():
        (copy / p.name).write_bytes(p.read_bytes())
    before = _build.library_path()
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path() == before
    src = copy / "gemm_residual.cu"
    src.write_text(src.read_text() + "\n// changed\n")
    assert _build.library_path() != before
