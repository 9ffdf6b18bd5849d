"""The int8 second product of the W8A8 sub-layers, `gemm_i8_residual`
(`mst_tpu_torch/csrc/gemm_i8_residual.cu`): the proj / fc2 / w3 product of
`_attn_i8_kernel`, `_mlp_i8_kernel` and `_swiglu_i8_kernel`
(`mst_tpu/ops/fused_int8.py`) with its dequantization, LayerScale and
residual, on the int8 TMA + wgmma mainloop of `gemm_sm90.cuh`, which reads
the weights K-major (`QDense.q8t`).

There is no card here, so the kernel does not run: these tests hold what
surrounds it on the CPU.

- the plain version against JAX's body of the second product
  (`_dot_i8`, then the dequantization, LayerScale and residual as the
  Pallas kernels write them), and against a numpy transcription of the
  kernel's epilogue, each step rounded on its own, bit for bit;
- the launch geometry (`gemm_i8_residual_launch`) at every K from 128 to
  4096 on 132 and 114 SMs, the tiles' two W^T boxes, its constants against
  the sources;
- the wrapper's refusals before any launch, and the source being the int8
  wgmma mainloop with no WMMA left.

`chip_smoke.py` phase 46 holds the geometry to the kernel's own export and
the kernel to the plain version on the card, with 0 difference."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_int8 as jq
from mst_tpu_torch.models.layers import QDense
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tq

ROWS = (1, 63, 128, 771, 8 * 32 * 201, 8 * 32 * 257)
# the path's second products (K, N): ViT-S proj / fc2, ViT-B / L proj and
# fc2, giant2 proj / w3
PATH = ((384, 384), (1536, 384), (768, 768), (3072, 768), (1024, 1024),
        (4096, 1024), (1536, 1536), (4096, 1536))
SMEM_LIMIT = 232_448


def _inputs(rng, m, k, n, static, dtype):
    """Codes (per token, or static) of a normal hidden, a quantized weight,
    x and a LayerScale, as the sub-layers hand them to the product."""
    h = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    if static:
        a, rs = tq._quant_rows_ref(h * 40.0, True), None
    else:
        a, rs = tq._quant_rows_ref(h)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32))
    q, s = tq.quantize_weight_int8(w)
    nd = QDense(q, s, torch.from_numpy(
        (0.1 * rng.standard_normal(n)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)
                         ).to(dtype)
    ls = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(n))
                          .astype(np.float32))
    return a, rs, nd, x, ls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_plain_matches_the_jax_body(static, with_ls, dtype):
    """`gemm_i8_residual` on CPU tensors (its plain version) against the
    Pallas bodies' second product in JAX: `_dot_i8` in int32, f32 of it [*
    the row scale] * the column scale + bias, [* ls], + f32(x), one cast;
    the wrapper takes the K-major copy as the sub-layers pass it."""
    rng = np.random.default_rng(30 + 4 * static + 2 * with_ls
                                + (dtype == torch.bfloat16))
    m, k, n = 131, 256, 384
    a, rs, nd, x, ls = _inputs(rng, m, k, n, static, dtype)
    lsv = ls if with_ls else None
    tfb.reset_launch_counts()
    got = tq.gemm_i8_residual(a, rs, nd.q8, nd.scale, nd.bias, lsv, x,
                              q8t=nd.q8t)
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no launch
    acc = jq._dot_i8(jnp.asarray(a.numpy()), jnp.asarray(nd.q8.numpy()))
    y = acc.astype(jnp.float32)
    if not static:
        y = y * jnp.asarray(rs.numpy())[:, None]
    y = y * jnp.asarray(nd.scale.numpy())[0] + jnp.asarray(nd.bias.numpy())
    if with_ls:
        y = y * jnp.asarray(ls.numpy())
    xf = jnp.asarray(x.float().numpy())
    want = np.asarray((xf + y).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                      else jnp.float32)).astype(np.float32)
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _bf16_rne(v):
    """f32 -> bf16 (kept as f32) by round to nearest even, as
    `__floats2bfloat162_rn`."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_plain_rounds_as_the_kernel_epilogue(static, with_ls):
    """The kernel's epilogue transcribed in numpy f32, one rounding a step
    (`__int2float_rn`, `__fmul_rn` by the row scale, by the column scale,
    `__fadd_rn` of the bias, `__fmul_rn` by ls, `__fadd_rn` to x, one bf16
    rounding): the plain version's bits, which phase 46 holds the kernel
    to with 0 difference. K = 4096 puts the sums above 2^24, where the s32
    -> f32 conversion rounds."""
    rng = np.random.default_rng(40 + 2 * static + with_ls)
    m, k, n = 64, 4096, 128
    a, rs, nd, x, ls = _inputs(rng, m, k, n, static, torch.bfloat16)
    a, q8 = a.clone(), nd.q8.clone()
    a[:4], q8[:, :4] = 127, 127  # row i . column j = 4096 x 127^2 for i, j < 4
    lsv = ls if with_ls else None
    got = tq.gemm_i8_residual(a, rs, q8, nd.scale, nd.bias, lsv, x,
                              q8t=q8.t().contiguous())
    acc = a.numpy().astype(np.int64) @ q8.numpy().astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    y = acc.astype(np.float32)  # round to nearest even, as __int2float_rn
    if not static:
        y = y * rs.numpy()[:, None]
    y = y * nd.scale.numpy()[0]
    y = y + nd.bias.numpy()
    if with_ls:
        y = y * ls.numpy()
    want = _bf16_rne(x.float().numpy() + y)
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- launch geometry ----------------------------------------------------------


def _constants(name):
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
    return {k: int(v) for k, v in re.findall(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text)}


def test_geometry_mirrors_the_sources():
    h = _constants("gemm_sm90.cuh")
    assert (h["BM"], h["BN"], h["BK8"]) == (tfb.GEMM_BM, tfb.GEMM_BN,
                                            tq.I8_BK)
    assert h["STAGES"] == tfb.GEMM_STAGES
    assert h["CONSUMERS"] * 128 + 32 == tfb.GEMM_THREADS
    geo = tq.gemm_i8_residual_launch(771, 384, 384)
    assert geo.smem == tfb.GEMM_SMEM <= SMEM_LIMIT
    cu = (_build.CSRC / "gemm_i8_residual.cu").read_text()
    for sym in ("mst_gemm_i8_residual", "mst_i8_residual_geometry"):
        assert f'extern "C" int {sym}(' in cu
        assert sym in _build._SIGNATURES
    # the export writes the seven numbers the mirror gives
    assert "const int g[7]" in cu and len(vars(geo)) == 7


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("k", range(128, 4096 + 1, 128))
def test_geometry_at_every_width(k, sms):
    """One persistent CTA per SM over the 128 x 128 output tiles (an H100
    SXM has 132 SMs, the PCIe card 114), the whole K in each unit."""
    for m in ROWS:
        for n in (128, 384, 1536):
            geo = tq.gemm_i8_residual_launch(m, k, n, sms)
            assert geo.tiles == -(-m // 128) * (n // 128)
            assert geo.grid == min(geo.tiles, sms)
            assert geo.k_tiles * 128 == k
            assert geo.second_box == 64
            assert geo.threads == 288 and geo.stages == tfb.GEMM_STAGES
            assert geo.smem == tfb.GEMM_SMEM


@pytest.mark.parametrize("k,n", PATH)
def test_boxes_cover_q8t_once(k, n):
    """A tile's two 64-row boxes of W^T = q8t: rows [n0, n0 + 64) and [n0 +
    64, n0 + 128); over the tiles of a row every q8t row is read once, and
    every K of the path is whole stages."""
    geo = tq.gemm_i8_residual_launch(8 * 32 * 257, k, n)
    assert geo.k_tiles * tq.I8_BK == k
    rows = []
    for t in range(n // 128):
        c0 = 128 * t
        c1 = c0 + geo.second_box
        rows += [*range(c0, c0 + 64), *range(c1, c1 + 64)]
    assert sorted(rows) == list(range(n))


def _no_library():
    raise AssertionError("the kernel library was reached")


def _operands(m, k, n):
    return (torch.zeros((m, k), dtype=torch.int8), torch.ones(m),
            torch.zeros((k, n), dtype=torch.int8),
            torch.zeros((n, k), dtype=torch.int8), torch.ones(n),
            torch.zeros(n), torch.ones(n),
            torch.zeros((m, n), dtype=torch.bfloat16))


@pytest.mark.parametrize("m,k,n,what", [
    (64, 320, 384, "K % 128"), (64, 64, 384, "K >= 128"),
    (64, 384, 192, "N % 128"), (64, 384, 64, "N >= 128"),
    (0, 384, 384, "M >= 1")])
def test_refuses_shapes_before_any_launch(monkeypatch, m, k, n, what):
    """K % 128 (the int8 stage depth; the WMMA kernel took K % 64), N %
    128 and M >= 1, checked on a CUDA tensor before the library is built
    or reached (`_on_cuda` forced on for CPU tensors), and by the mirror."""
    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    a, rs, q8, q8t, sc, bi, ls, x = _operands(m, k, n)
    with pytest.raises(ValueError, match="gemm_i8_residual needs M >= 1, "
                       "K % 128"):
        tq.gemm_i8_residual(a, rs, q8, sc, bi, ls, x, q8t=q8t)
    with pytest.raises(ValueError):
        tq.gemm_i8_residual_launch(m, k, n)


def test_refuses_operands_before_any_launch(monkeypatch):
    """The K-major weights are required on CUDA (as `ln_gemm_i8`'s); codes,
    weights, x and the row scale of another type or shape raise before
    the library is reached."""
    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    m, k, n = 771, 384, 384
    a, rs, q8, q8t, sc, bi, ls, x = _operands(m, k, n)
    with pytest.raises(ValueError, match="needs q8t"):
        tq.gemm_i8_residual(a, rs, q8, sc, bi, ls, x)
    with pytest.raises(ValueError, match="q8t has shape"):
        tq.gemm_i8_residual(a, rs, q8, sc, bi, ls, x,
                            q8t=torch.zeros((n, 2 * k), dtype=torch.int8))
    with pytest.raises(TypeError, match="q8t must be int8"):
        tq.gemm_i8_residual(a, rs, q8, sc, bi, ls, x, q8t=q8t.float())
    with pytest.raises(TypeError, match="a must be int8"):
        tq.gemm_i8_residual(a.float(), rs, q8, sc, bi, ls, x, q8t=q8t)
    with pytest.raises(TypeError, match="x must be bfloat16"):
        tq.gemm_i8_residual(a, rs, q8, sc, bi, ls, x.float(), q8t=q8t)
    with pytest.raises(ValueError, match="row_scale must be"):
        tq.gemm_i8_residual(a, rs.double(), q8, sc, bi, ls, x, q8t=q8t)
    with pytest.raises(ValueError, match="q8 has shape"):
        tq.gemm_i8_residual(a, rs, torch.zeros((2 * k, n), dtype=torch.int8),
                            sc, bi, ls, x, q8t=q8t)


@pytest.mark.parametrize("static", [False, True])
def test_accepts_kernel_shapes(monkeypatch, static):
    """A path shape passes every check and reaches the library (a stand-in
    that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    a, rs, q8, q8t, sc, bi, ls, x = _operands(771, 4096, 1536)
    with pytest.raises(Reached):
        tq.gemm_i8_residual(a, None if static else rs, q8, sc, bi, ls, x,
                            q8t=q8t)


def test_sublayers_pass_the_kmajor_form(monkeypatch):
    """Every caller of the wrapper hands it `q8t` (without it the CUDA path
    raises)."""
    import inspect

    from mst_tpu_torch.tools import bench_attn_i8

    for fn in (tq.fused_attention_sublayer_i8, tq.fused_mlp_sublayer_i8,
               tq.fused_swiglu_sublayer_i8, bench_attn_i8.sublayer):
        src = inspect.getsource(fn)
        calls = re.findall(r"gemm_i8_residual\(([^)]*)\)", src, re.S)
        assert calls and all("q8t=" in c for c in calls), fn.__name__


def test_source_is_the_int8_wgmma_mainloop():
    """`gemm_i8_residual.cu` runs its product on the int8 wgmma of the
    shared mainloop (both operands K-major, the weights as two 64-row boxes
    of q8t), with no WMMA / mma.sync left and no fused multiply-add in the
    epilogue."""
    text = (_build.CSRC / "gemm_i8_residual.cu").read_text()
    code = re.sub(r"//[^\n]*", "", text)
    assert "wmma" not in code and "mma_sync" not in code
    assert '#include "gemm_sm90.cuh"' in code
    assert "producer<K_MAJOR, K_MAJOR_PAIR, BK8>" in code
    assert "consumer_tile<K_MAJOR, K_MAJOR_PAIR>" in code
    assert "int d[ACC]" in code and "load_slab(" in code
    assert "fma" not in code.lower()
    assert "__fmul_rn" in code and "__fadd_rn" in code
    assert "__int2float_rn" in code
    header = (_build.CSRC / "gemm_sm90.cuh").read_text()
    assert "m64n128k32.s32.s8.s8" in header
    assert "void load_slab(" in header
    assert "load_slab" not in re.sub(
        r"load_slab\(epi", "", (_build.CSRC / "gemm_residual.cu").read_text())
