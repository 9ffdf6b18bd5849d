"""The LN pullback `ln_pullback` (`mst_tpu_torch/csrc/gemm_dgrad.cu`): one
bandwidth-bound pass over the rows in which each lane owns the same
columns of every row (a row taken by 1, 2 or 4 warps), then one
fixed-order pass over the blocks' column sums.

There is no card here, so the kernels do not run: these tests hold what
surrounds them. The launch geometry (`ln_pullback_launch`) at every K it
accepts and at ragged row counts: every column in one lane's chunks, every
block given a row, shared memory and workspace as the kernel asks; its
constants against the source; the kernel's order of the column sums
(rows within a group, the groups of a block, then the blocks in the
second pass's order) in f32 against the f64 sum; the plain version
against JAX's `_ln_bwd` plus the residual; the wrapper's refusals before
any launch. `chip_smoke.py` phases 2 and 45 hold the geometry to the
kernel's export and the kernel to the plain version on the card."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb

SMEM_LIMIT = 232_448
ROWS = (1, 7, 8, 771, 2112, 8 * 32 * 201, 8 * 32 * 257, 2 * 32 * 257)
WIDTHS = range(32, tfb.LN_PULLBACK_MAX_K + 1, 32)


@pytest.mark.parametrize("k", WIDTHS)
def test_geometry_at_every_width(k):
    for m in ROWS:
        geo = tfb.ln_pullback_launch(m, k)
        wr, ch = geo.warps_a_row, geo.chunks
        # the narrowest group of warps whose lanes hold at most 3 chunks
        assert wr == min(w for w in (1, 2, 4) if k <= 384 * w)
        assert 2 <= ch <= 3 and ch * 128 * wr >= k
        assert ch == 2 or (ch - 1) * 128 * wr < k
        groups = 8 // wr
        # a persistent grid of at most two blocks an SM, each given a row
        assert geo.grid == min(-(-m // groups), 2 * 132)
        assert (geo.grid - 1) * groups < m
        assert geo.threads == 256 and geo.smem == groups * 2 * k * 4
        assert 2 * geo.smem <= SMEM_LIMIT  # two blocks an SM
        assert geo.workspace == geo.grid * 2 * k * 4
        assert geo.sum_blocks * 32 >= 2 * k > (geo.sum_blocks - 1) * 32
        assert geo.sum_threads == 256


@pytest.mark.parametrize("k", [384, 768, 1024, 1536, 160])
def test_every_column_in_one_lane(k):
    """Lane l of a group of WR warps owns columns 4 (l + 32 WR j) .. + 3
    for chunk j < chunks: every column of the row exactly once."""
    geo = tfb.ln_pullback_launch(771, k)
    wr = geo.warps_a_row
    cols = [4 * (lane + 32 * wr * j) + e for lane in range(32 * wr)
            for j in range(geo.chunks) for e in range(4)
            if 4 * (lane + 32 * wr * j) < k]
    assert sorted(cols) == list(range(k))


def test_geometry_mirrors_the_source():
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "gemm_dgrad.cu").read_text())
    c = {k: int(v) for k, v in re.findall(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text)}
    assert (c["PB_WARPS"], c["PB_BLOCKS_PER_SM"], c["PS_WARPS"]) == (
        tfb._PB_WARPS, tfb._PB_BLOCKS_PER_SM, tfb._PS_WARPS)
    assert c["PB_MAX_K"] == tfb.LN_PULLBACK_MAX_K
    # the instances the launch can pick, each in the source's dispatch
    picked = {(tfb.ln_pullback_launch(8, k).warps_a_row,
               tfb.ln_pullback_launch(8, k).chunks) for k in WIDTHS}
    for wr, ch in picked:
        assert f"MST_PB({wr}, {ch})" in text
    assert "atomicAdd" not in text


def _kernel_order_sum(v, grid, groups, ps_warps=8):
    """Column sums of v [m, n] as `ln_pullback` orders them, in f32: group
    q of the grid adds its rows q, q + G, ... in turn; a block adds its
    groups in order; the second pass's warp w adds the blocks w, w + 8,
    ... in turn, then the 8 warps' sums in order."""
    v = v.astype(np.float32)
    g_count = grid * groups
    per_group = np.zeros((g_count, v.shape[1]), np.float32)
    for r in range(v.shape[0]):
        per_group[r % g_count] += v[r]
    blocks = np.zeros((grid, v.shape[1]), np.float32)
    for b in range(grid):
        for q in range(groups):
            blocks[b] += per_group[b * groups + q]
    lanes = np.zeros((ps_warps, v.shape[1]), np.float32)
    for p in range(grid):
        lanes[p % ps_warps] += blocks[p]
    out = np.zeros(v.shape[1], np.float32)
    for w in range(ps_warps):
        out += lanes[w]
    return out


@pytest.mark.parametrize("m,k,sms", [(4113, 384, 4), (2057, 768, 3),
                                     (3001, 1536, 2), (771, 160, 132)])
def test_column_sum_order_against_f64(m, k, sms):
    """dln_s = sum dh * xhat and dln_b = sum dh in the kernel's fixed order
    stay within 1e-6 of the largest |sum| of the f64 sums (the card-side
    limit on these outputs is 2e-5 of it)."""
    rng = np.random.default_rng(m)
    d = rng.standard_normal((m, k)).astype(np.float32)
    geo = tfb.ln_pullback_launch(m, k, sms)
    got = _kernel_order_sum(d, geo.grid, 8 // geo.warps_a_row)
    want = d.astype(np.float64).sum(0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("k", [384, 768, 1536])
def test_plain_pullback_matches_jax_ln_bwd(k):
    """`_ln_pullback_ref` (the kernel's plain version) against `jax.vjp` of
    JAX's `_ln` plus the residual, in f32."""
    rng = np.random.default_rng(k)
    m = 97
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, k)).astype(np.float32)
    d = rng.standard_normal((m, k)).astype(np.float32)
    ln_s = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    dx, dls, dlb = tfb._ln_pullback_ref(torch.from_numpy(d),
                                        torch.from_numpy(x),
                                        torch.from_numpy(g),
                                        torch.from_numpy(ln_s), 1e-6)
    _, vjp = jax.vjp(lambda x_, s_, b_: jfb._ln(x_, s_, b_, 1e-6),
                     jnp.asarray(x), jnp.asarray(ln_s), jnp.zeros(k))
    jdx, jds, jdb = vjp(jnp.asarray(d))
    for ours, ref in ((dx.numpy(), np.asarray(jdx) + g),
                      (dls.numpy(), np.asarray(jds)),
                      (dlb.numpy(), np.asarray(jdb))):
        scale = np.abs(ref).max()
        assert np.abs(ours - ref).max() <= 2e-5 * scale


def _no_library():
    raise AssertionError("the kernel library was reached")


@pytest.mark.parametrize("m,k", [(64, 400), (64, 1568), (0, 384), (64, 16)])
def test_refuses_shapes_before_any_launch(monkeypatch, m, k):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    monkeypatch.setattr(tfb, "_sms", lambda t: 132)
    bf = torch.zeros((m, k), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ln_pullback needs"):
        tfb.ln_pullback(torch.zeros(m, k), bf, bf, torch.ones(k), 1e-6)
    with pytest.raises(ValueError, match="ln_pullback needs"):
        tfb.ln_pullback_launch(m, k)


def test_refuses_operands_before_any_launch(monkeypatch):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    monkeypatch.setattr(tfb, "_sms", lambda t: 132)
    m, k = 64, 384
    bf = torch.zeros((m, k), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dh must be contiguous"):
        tfb.ln_pullback(torch.zeros(m, k, dtype=torch.float64), bf, bf,
                        torch.ones(k), 1e-6)
    with pytest.raises(ValueError, match="dh must be contiguous"):
        tfb.ln_pullback(torch.zeros(m, 2 * k)[:, :k], bf, bf, torch.ones(k),
                        1e-6)
    with pytest.raises(ValueError, match="g has shape"):
        tfb.ln_pullback(torch.zeros(m, k), bf, bf[:-1], torch.ones(k), 1e-6)


@pytest.mark.parametrize("m,k", [(771, 384), (1, 1536), (8224, 160)])
def test_accepts_kernel_shapes(monkeypatch, m, k):
    """A shape the kernel takes passes the checks and reaches the library
    (a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tfb, "_sms", lambda t: 132)
    monkeypatch.setattr(_build, "lib", stand_in)
    bf = torch.zeros((m, k), dtype=torch.bfloat16)
    with pytest.raises(Reached):
        tfb.ln_pullback(torch.zeros(m, k), bf, bf, torch.ones(k), 1e-6)


def test_source_is_built_and_bound():
    text = (_build.CSRC / "gemm_dgrad.cu").read_text()
    for sym in ("mst_ln_pullback", "mst_ln_pullback_geometry"):
        assert sym in _build._SIGNATURES
        assert f"int {sym}(" in text
    # one second pass, no sum_partials launches left in the pullback
    assert "sum_partials(" not in text and "ln_pullback_sum_kernel<<<" in text
