"""The per-token int8 quantizer of the W8A8 sub-layers, `quant_rows`
(`mst_tpu_torch/csrc/quant_rows.cu`): the `_quant_rows` / `_quant_static`
calls of `_attn_i8_kernel`, `_mlp_i8_kernel` and `_swiglu_i8_kernel`
(`mst_tpu/ops/fused_int8.py`) on the inputs of the second product, the
attention output o (bf16) and the f32 FFN hidden. On the card persistent
blocks stage whole rows in shared memory by TMA bulk copies on an
`mbarrier` ring and read each row once.

There is no card here, so the kernel does not run: these tests hold what
surrounds it on the CPU.

- the plain version against JAX's `_quant_rows` / `_quant_static` bit for
  bit, in bf16 and f32, with .5 ties, an all-zero row and amaxes on a
  multiple of 127;
- a numpy transcription of the kernel (its launch plan, the ring's stages
  and their wrap, each team's rows, the lanes' rotated chunk order and its
  undoing, the per-row amax, `__fmul_rn`, `__frcp_rn`, round half to even)
  against the plain version, bit for bit;
- the launch plan (`quant_rows_launch`): every row in exactly one group of
  exactly one block, no copy past the input, at the path shapes on 132
  and 114 SMs; its constants against the source;
- the wrapper's refusals before any launch.

`chip_smoke.py` phase 47 holds the plan to the kernel's own export and the
kernel to the plain version on the card, with 0 difference."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_int8 as jq
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tq

PATH_M = (8 * 32 * 257, 771, 1)
# the widths the sub-layers quantize (ViT-S o / u, ViT-B, giant2 o / ViT-L
# u, giant2 g), one wider than a stage (f32: 36 KB a row, two stages) and
# one wider than the ring (f32: 128 KB, streamed)
WIDE_K, STREAMED_K = 9216, 32768
PATH_K = (384, 768, 1536, 3072, 4096, WIDE_K)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _rows(rng, m, k):
    """A seeded [m, k] f32 block: rows of spread magnitudes, .5 ties at
    their exact scale, an all-zero row, and rows whose amax is 127 and
    254."""
    h = (rng.standard_normal((m, k)) * rng.uniform(0.01, 50, (m, 1))
         ).astype(np.float32)
    h[1] = 0.0  # the 1e-12 floor of the scale
    h[2, :6] = [127.0, -63.5, 0.5, 1.5, -2.5, 126.5]
    h[2, 6:] = np.clip(h[2, 6:], -100.0, 100.0)  # amax 127: scale ~ 1
    h[3] = np.clip(h[3] * (200.0 / np.abs(h[3]).max()), -200.0, 200.0)
    h[3, 5] = -254.0  # amax exactly 254
    h[4, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -200.0]
    return h


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("static", [False, True])
def test_plain_matches_the_jax_body(static, dtype):
    """`_quant_rows_ref` (what the wrapper runs on a CPU tensor) against the
    Pallas bodies' `_quant_rows` / `_quant_static` on the f32 of the same
    values (the bodies quantize `o.astype(f32)` and the f32 hidden), bit
    for bit: codes and scales."""
    rng = np.random.default_rng(70 + 2 * static + (dtype == "bf16"))
    h = _rows(rng, 24, 96)
    v = torch.from_numpy(h).to(DTYPES[dtype])
    hv = jnp.asarray(v.float().numpy())
    tfb.reset_launch_counts()
    got = tq.quant_rows(v, static)
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no launch
    if static:
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jq._quant_static(hv)))
        return
    q, sc = got
    jqr, jsc = jq._quant_rows(hv)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqr))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc)[:, 0])
    assert float(sc[1]) == np.float32(np.float32(1e-12) * np.float32(1 / 127))
    assert int(np.abs(q[3].numpy().astype(np.int32)).max()) == 127


# -- the kernel, transcribed --------------------------------------------------


def _codes(x, mul, static):
    """The kernel's codes of f32 values x: y = __fmul_rn(x, mul), or
    clip(x, -127, 127) (static); then the low byte of the bits of
    __fadd_rn(y, 1.5 * 2^23), which rounds y half to even."""
    x = np.asarray(x, np.float32)
    y = np.clip(x, -127, 127) if static else np.float32(x * np.float32(mul))
    bits = (y + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)


def _pack(c):
    """Four codes as one little-endian 32-bit word."""
    return sum((int(c[e]) & 0xFF) << (8 * e) for e in range(4))


def _lane_rot(lane, nc):
    return (lane // (8 // nc)) & (nc - 1)


def _kernel_in_numpy(v, static, sms):
    """quant_rows.cu's kernel step by step on a CPU tensor v [M, K]:
    `grid` blocks walk their groups; a producer fills the ring's stages
    from the group's contiguous bytes (values here; the stages a group
    does not fill hold garbage), one bulk copy a stage; each team of `wpr`
    warps takes its rows; a thread reads its vector's 16-byte chunks in
    its lane's rotated order, the amax over the team, then the codes,
    whose words it puts back in column order. -> (codes, scales)."""
    m, k = v.shape
    es = 4 if v.dtype == torch.float32 else 2
    geo = tq.quant_rows_launch(m, k, sms, v.dtype, static)
    flat = v.float().numpy().ravel()
    per_stage = geo.stage // es
    ring = np.empty(per_stage * geo.stages, np.float32)
    vec, epc = geo.vec, 16 // es
    nc = vec // epc
    vpr = k // vec
    tn = 32 * geo.wpr  # a team's threads
    q = np.full((m, k), -99, np.int64)
    scale = np.full(m, np.nan, np.float32)

    def vector_codes(at, tt, mul):
        """The codes of the vector whose values start at ring index `at`,
        as thread tt (lane tt % 32) stores them."""
        rot = _lane_rot(tt % 32, nc)
        words = [[_pack(_codes(ring[at + epc * ((c + rot) % nc) + 4 * j:][:4],
                               mul, static))
                  for j in range(epc // 4)] for c in range(nc)]
        out = []
        for kk in range(nc):  # chunk kk's words: the step (kk - rot) % nc
            out += words[(kk - rot) % nc]
        return np.frombuffer(np.array(out, np.uint32).tobytes(), np.int8)

    def amax_at(at):
        return np.abs(ring[at:at + vec]).max()

    def row_mul(a, row):
        s = np.float32(np.float32(max(a, np.float32(1e-12)))
                       * np.float32(1.0 / 127.0))
        scale[row] = s
        return np.float32(1.0) / s  # correctly rounded, as __frcp_rn

    for b in range(geo.grid):
        it = 0
        for g in range(b, geo.groups, geo.grid):
            r0 = g * geo.rows
            rows = min(geo.rows, m - r0)
            src = flat[r0 * k:(r0 + rows) * k]
            nch = -(-src.size // per_stage)
            if not geo.streamed:
                ring[:] = 3e38  # what a stage held before
                for c in range(nch):
                    st = (it + c) % geo.stages
                    part = src[c * per_stage:(c + 1) * per_stage]
                    ring[st * per_stage:st * per_stage + part.size] = part
                s0 = (it % geo.stages) * per_stage

                def at(off, s0=s0):
                    return (s0 + off) % ring.size
                muls = [1.0] * rows
                if not static:  # team r % teams takes row r's amax
                    for r in range(rows):
                        a = max((amax_at(at(r * k + v_ * vec))
                                 for v_ in range(vpr)), default=0.0)
                        muls[r] = row_mul(a, r0 + r)
                # the codes: one flat sweep over the group's vectors
                out = q[r0:r0 + rows].reshape(-1)
                for v_ in range(rows * vpr):
                    row = (0 if rows == 1 else int(np.float32(
                        np.float32(v_ + 0.5) * np.float32(1.0 / vpr))))
                    assert row == v_ // vpr
                    out[v_ * vec:(v_ + 1) * vec] = vector_codes(
                        at(v_ * vec), v_ % 256, muls[row])
                it += nch
            else:  # one row, chunk by chunk, `passes` times
                mul, a = 1.0, np.float32(0.0)
                for p in range(geo.passes):
                    last = p == geo.passes - 1
                    for c in range(geo.chunks):
                        st = it % geo.stages
                        ring[:] = 3e38
                        part = src[c * per_stage:(c + 1) * per_stage]
                        ring[st * per_stage:st * per_stage + part.size] = part
                        for v_ in range(part.size // vec):
                            col = c * per_stage + v_ * vec
                            if last:
                                q[r0, col:col + vec] = vector_codes(
                                    st * per_stage + v_ * vec, v_ % tn, mul)
                            else:
                                a = max(a, amax_at(st * per_stage + v_ * vec))
                        it += 1
                    if not last:
                        mul = row_mul(a, r0)
    return q, scale


@pytest.mark.parametrize("m,k,dtype,sms", [
    (43, 384, "bf16", 1), (50, 1536, "bf16", 2), (12, 1536, "f32", 1),
    (7, 4096, "f32", 2), (5, 4104, "f32", 1), (6, 392, "bf16", 3),
    (4, WIDE_K, "f32", 1), (3, 24576, "bf16", 1), (2, STREAMED_K, "f32", 1),
    (2, 49160, "bf16", 1)])
@pytest.mark.parametrize("static", [False, True])
def test_kernel_steps_match_the_plain_version(m, k, dtype, sms, static):
    """The transcription of the kernel against `_quant_rows_ref`, bit for
    bit, on plans that take every branch: many rows a group with one warp
    a row (ViT-S o), teams of 4 warps (giant2 o, g), K % 16 == 8 (8 values
    a thread, 8-byte stores), a row of two stages (whose group wraps the
    ring on the second group of a block), a row of three, and rows wider
    than the ring (streamed: twice dynamic, once static). Few SMs make
    each block walk several groups."""
    rng = np.random.default_rng(k + m + 7 * static)
    v = torch.from_numpy(_rows(rng, max(m, 5), k)[:m]).to(DTYPES[dtype])
    geo = tq.quant_rows_launch(m, k, sms, v.dtype, static)
    q, scale = _kernel_in_numpy(v, static, sms)
    if static:
        want = tq._quant_rows_ref(v, True)
    else:
        want, wsc = tq._quant_rows_ref(v)
        np.testing.assert_array_equal(scale, wsc.numpy())
    np.testing.assert_array_equal(q, want.numpy().astype(np.int64))
    assert geo.streamed == (k * (4 if dtype == "f32" else 2)
                            > tq.QR_STAGE * tq.QR_STAGES)


def test_rotated_chunks_cover_the_bank_groups():
    """The eight lanes of a shared-memory phase, each reading its 16-byte
    chunk of consecutive 32- or 64-byte vectors in its rotated order,
    touch eight distinct bank groups (16 bytes each, 128 bytes a row of
    banks) at every step."""
    for nc in (1, 2, 4):
        for phase in range(4):
            for step in range(nc):
                groups = {((8 * phase + lane) * nc
                           + (step + _lane_rot(8 * phase + lane, nc)) % nc) % 8
                          for lane in range(8)}
                assert len(groups) == 8, (nc, phase, step)


# -- the launch plan ----------------------------------------------------------


def _constants():
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "quant_rows.cu").read_text())
    return {k: int(v) for k, v in re.findall(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text)}


def test_plan_mirrors_the_source():
    c = _constants()
    assert (c["QR_STAGE"], c["QR_STAGES"], c["QR_WARPS"],
            c["QR_BLOCKS_PER_SM"], c["QR_MAX_ROWS"]) == (
        tq.QR_STAGE, tq.QR_STAGES, tq.QR_WARPS, tq.QR_BLOCKS_PER_SM,
        tq.QR_MAX_ROWS)
    geo = tq.quant_rows_launch(771, 1536)
    # two persistent blocks an SM: each block's ring and barriers fit
    assert 2 * geo.smem <= 228 * 1024 - 2 * 1024
    assert geo.threads == 32 * tq.QR_WARPS + 32
    cu = (_build.CSRC / "quant_rows.cu").read_text()
    for sym in ("mst_quant_rows", "mst_quant_rows_geometry"):
        assert f'extern "C" int {sym}(' in cu
        assert sym in _build._SIGNATURES
    # the export writes the twelve numbers the mirror gives
    assert "const int g[12]" in cu and len(vars(geo)) == 12
    # rows staged by 1D TMA bulk copies on the ring's mbarriers
    assert "cp.async.bulk.shared::cluster.global.mbarrier" in cu
    assert "mbar_expect_tx" in cu and "mbar_wait" in cu


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("k", PATH_K + (STREAMED_K,))
@pytest.mark.parametrize("m", PATH_M)
def test_plan_covers_every_row_once(m, k, dtype, static, sms):
    """Block b walks groups b, b + grid, ...: every group belongs to one
    block below the grid, every row to one group, each group's bytes fit
    the stages it is given (and the ring, unless streamed), and no copy
    reads past the input."""
    es = 4 if dtype == "f32" else 2
    geo = tq.quant_rows_launch(m, k, sms, DTYPES[dtype], static)
    assert 1 <= geo.grid <= sms * tq.QR_BLOCKS_PER_SM and geo.grid <= geo.groups
    owner = np.full(geo.groups, -1)
    for b in range(geo.grid):
        mine = np.arange(b, geo.groups, geo.grid)
        assert (owner[mine] == -1).all()
        owner[mine] = b
    assert (owner >= 0).all()
    r0 = np.arange(geo.groups) * geo.rows
    rows = np.minimum(geo.rows, m - r0)
    assert (rows >= 1).all() and rows.sum() == m
    assert (np.diff(r0) == geo.rows).all() and r0[-1] + rows[-1] == m
    gbytes = rows * k * es
    assert gbytes.max() <= geo.chunks * geo.stage
    assert (r0 * k * es + gbytes).max() == m * k * es  # nothing past the end
    assert all(b % 16 == 0 for b in (k * es, geo.stage))  # bulk copy sizes
    assert geo.streamed == (geo.chunks > geo.stages)
    assert geo.passes == (2 if geo.streamed and not static else 1)
    assert geo.vec == 16 and k % geo.vec == 0
    assert tq.QR_WARPS % geo.wpr == 0
    if not geo.streamed and k * es <= geo.stage:
        assert geo.rows == min(geo.stage // (k * es), tq.QR_MAX_ROWS, m)


@pytest.mark.parametrize("m,k,dtype,rows,wpr", [
    (65_792, 384, "bf16", 16, 1), (65_792, 1536, "f32", 5, 1),
    (65_792, 1536, "bf16", 10, 4), (65_792, 4096, "f32", 2, 4),
    (65_792, WIDE_K, "f32", 1, 8), (771, 384, "bf16", 16, 1)])
def test_plan_at_the_path_shapes(m, k, dtype, rows, wpr):
    """The plan the path shapes get: ViT-S o 16 rows a group (the cap; 42
    would fit a stage), a warp a row; its f32 u 5 rows, a warp a row;
    giant2 o 10 rows and its g 2 rows, 4 warps a row; a two-stage row the
    whole block. Two blocks an SM (264 on 132 SMs) while there are groups
    for them."""
    geo = tq.quant_rows_launch(m, k, 132, DTYPES[dtype])
    assert (geo.rows, geo.wpr, geo.chunks) == (rows, wpr,
                                               2 if k == WIDE_K else 1)
    assert geo.grid == min(264, -(-m // rows))


def test_plan_follows_the_sm_count():
    """The grid is two blocks per SM of the card the wrapper runs on, not
    of an H100 SXM (C6)."""
    for sms in (132, 114, 16):
        assert tq.quant_rows_launch(65_792, 1536, sms).grid == 2 * sms


# -- refusals -----------------------------------------------------------------


def _no_library():
    raise AssertionError("the kernel library was reached")


@pytest.mark.parametrize("case", ["K % 8", "dtype", "strided", "aligned"])
def test_refuses_before_any_launch(monkeypatch, case):
    """K % 8 == 0, bf16 or f32, contiguous and 16-byte aligned, checked on
    a CUDA tensor (`_on_cuda` forced on for CPU tensors) before the
    library is built or reached; the plan refuses the same K."""
    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    v = torch.zeros((771, 1536), dtype=torch.float32)
    if case == "K % 8":
        with pytest.raises(ValueError, match="K % 8 == 0"):
            tq.quant_rows(torch.zeros((771, 1540)))
        with pytest.raises(ValueError):
            tq.quant_rows_launch(771, 1540)
    elif case == "dtype":
        with pytest.raises(TypeError, match="bf16 or f32"):
            tq.quant_rows(v.half())
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            tq.quant_rows(v[:, ::2])
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tq.quant_rows(v.view(-1)[2:2 + 770 * 1536].view(770, 1536))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_accepts_kernel_shapes(monkeypatch, static, dtype):
    """A path shape passes every check and reaches the library, given the
    card's SM count (a stand-in that records the call)."""
    calls = []

    class Lib:
        def mst_quant_rows(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tq, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tq.fb, "_sms", lambda t: 114)
    monkeypatch.setattr(tq, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "lib", Lib)
    tq.quant_rows.launches = 0
    out = tq.quant_rows(torch.zeros((771, 4096), dtype=DTYPES[dtype]),
                        static)
    (src, is_f32, qp, sp, m, k, sms, stream), = calls
    assert (is_f32, m, k, sms) == (int(dtype == "f32"), 771, 4096, 114)
    assert (sp is None) == static and tq.quant_rows.launches == 1
    q = out if static else out[0]
    assert q.dtype == torch.int8 and q.shape == (771, 4096)
