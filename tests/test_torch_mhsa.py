"""`mhsa` and `mhsa_bwd` on TMA + wgmma with the scores in registers
(`mst_tpu_torch/csrc/attn_sm90.cuh`, `mhsa.cu`, `mhsa_bwd.cu`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them. The launch geometry the wrappers and the card-side checks
read (`mhsa_launch`) at every S from 1 to 512 and the model head counts:
every query row in one tile, every key in one chunk, the forward's
registers and each kernel's shared memory within a block's; its constants
against the sources; the two sums the kernels order their own way (the
rollout carry's fixed order, the two-pass softmax's rescaled l) against
the f64 sums; the plain versions against `mst_tpu`'s `_mhsa` (every
output form, RoPE) and against `jax.vjp` of it and `jax.grad` of
`_attn_ref`; the wrappers' shape refusals before any launch.
`chip_smoke.py` phases 2 and 43 hold the same geometry to the kernels'
own export and the kernels to their plain versions on the card."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
SM_SMEM = 233_472  # shared memory of one H100 SM (228 KB)
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
HEADS = (6, 12, 16, 24)  # ViT-S, ViT-B, ViT-L, giant2
LENGTHS = (9, 201, 257, 442, 512)  # tiny, DINOv3 and ViT-S at 224 px, C3


def _close(ours, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol,
                               err_msg=what)


# -- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("heads", HEADS)
def test_geometry_covers_every_row_and_key_once(heads):
    for s in range(1, 513):
        g = tfb.mhsa_launch(s)
        # query tiles: every row in exactly one 64-row tile (the grid is
        # (tiles, heads, N); the Abnar grid (tiles, N))
        assert g.tile == 64 and (g.tiles - 1) * 64 < s <= g.tiles * 64
        owners = np.zeros(s, int)
        for t in range(g.tiles):
            owners[t * 64:min(s, (t + 1) * 64)] += 1
        assert (owners == 1).all()
        # key chunks: 64-key chunks, then a 16-key tail; every key in one,
        # and a chunk starts below S
        keys = np.zeros(s, int)
        starts = [64 * c for c in range(g.chunks64 + g.tail16)]
        widths = [64] * g.chunks64 + [16] * g.tail16
        for k0, w in zip(starts, widths):
            assert k0 < s
            keys[k0:min(s, k0 + w)] += 1
        assert (keys == 1).all()
        assert g.tail16 == (0 < s % 64 <= 16)
        # one pass where every score of a row fits a thread's registers
        assert g.passes == (1 if s <= 272 else 2)
        assert g.chunks64 == s // 64 + (s % 64 > 16)
        assert g.score_regs == (32 * g.chunks64 + 8 * g.tail16
                                if g.passes == 1 else 32)
        assert g.score_regs <= 136
        assert max(g.smem, g.abnar_smem, g.bwd_smem) <= SMEM_LIMIT
        assert g.abnar_smem == g.smem + (136 * 128 * 4 if g.passes == 1 else 0)
        assert g.threads == 128
        # a block walks at most 5 (backward 3) tiles, the tiles shared out
        # evenly over the fewest blocks: every tile in one block
        for tpb, most in ((g.tiles_per_block, 5), (g.bwd_tiles_per_block, 3)):
            blocks = -(-g.tiles // tpb)
            assert 1 <= tpb <= most and blocks == -(-g.tiles // most)
            assert (blocks - 1) * tpb < g.tiles <= blocks * tpb
        assert tfb.abnar_query_tile(s) == 64
    # the ViT-S / giant2 length: two blocks an SM for each kernel (the
    # Abnar kernel's one); a forward block walks the head's 5 tiles, a
    # backward one 3 or 2
    g = tfb.mhsa_launch(257)
    assert 2 * (g.smem + 1024) <= SM_SMEM and 2 * (g.bwd_smem + 1024) <= SM_SMEM
    assert (g.passes, g.chunks64, g.tail16, g.score_regs) == (1, 4, 1, 136)
    assert (g.tiles_per_block, g.bwd_tiles_per_block) == (5, 3)


def test_geometry_refuses_lengths_past_512():
    for s in (0, 513, 1370):
        with pytest.raises(ValueError, match="1 <= S <= 512"):
            tfb.mhsa_launch(s)


def _constants(*names):
    """The `constexpr` ints of the sources in order (a header first), as
    the compiler would evaluate them (integer division, size_t as int)."""
    env = {}
    for name in names:
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for key, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
            expr = expr.replace("size_t(", "int(").replace("/", "//")
            env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def test_launch_geometry_mirrors_the_sources():
    c = _constants("gemm_sm90.cuh", "attn_sm90.cuh", "mhsa.cu")
    assert (c["TILE"], c["CHUNK"], c["TAIL"], c["THREADS"], c["MAX_S"]) == (
        tfb.MHSA_TILE, tfb.MHSA_CHUNK, tfb.MHSA_TAIL, tfb.MHSA_THREADS,
        tfb.MHSA_MAX_S)
    assert c["ONE_PASS_MAX"] == tfb.MHSA_ONE_PASS_MAX == 272
    assert c["BOX_BYTES"] == 64 * 64 * 2 and c["ALIGN"] == 1024
    assert c["RED_LD"] == c["MAX_S"] and c["WARPS"] == 4
    head = (_build.CSRC / "attn_sm90.cuh").read_text()
    assert re.search(r"p\.n64 = full \+ \(rest > TAIL \? 1 : 0\);", head)
    assert re.search(r"p\.tail = rest > 0 && rest <= TAIL \? 1 : 0;", head)
    fwd = (_build.CSRC / "mhsa.cu").read_text()
    bwd = (_build.CSRC / "mhsa_bwd.cu").read_text()
    # the layouts the mirror sums: Q, K and V boxes, the carry's sums, the
    # barriers; the two tiles, the two operands' boxes, two f32 vectors
    for pat in (r"L\.k = L\.q \+ 2 \* BOX_BYTES;",
                r"L\.v = L\.k \+ operand_bytes\(p\);",
                r"L\.red = L\.v \+ operand_bytes\(p\);",
                r"L\.bar = L\.red \+ size_t\(WARPS\) \* RED_LD \* sizeof\(float\);",
                r"L\.asum = L\.bar \+ size_t\(2 \+ p\.boxes\) \* sizeof\(uint64_t\);",
                r"const bool smem_sum = abnar && S <= ONE_PASS_MAX;",
                r"L\.total = ALIGN \+ L\.asum \+ \(smem_sum \? size_t\(ASUM_REGS\) \* "
                r"THREADS \* sizeof\(float\) : 0\);",
                r"const bool two = S > ONE_PASS_MAX;",
                r"tiles_per_block\(S, MOST_TILES\)"):
        assert re.search(pat, fwd), pat
    for pat in (r"L\.all0 = L\.tiles \+ 4 \* BOX_BYTES;",
                r"L\.all1 = L\.all0 \+ operand_bytes\(p\);",
                r"L\.vec = L\.all1 \+ operand_bytes\(p\);",
                r"L\.bar = L\.vec \+ 2 \* size_t\(p\.boxes\) \* CHUNK \* "
                r"sizeof\(float\);",
                r"L\.total = ALIGN \+ L\.bar \+ size_t\(2 \+ p\.boxes\) \* "
                r"sizeof\(uint64_t\);"):
        assert re.search(pat, bwd), pat
    assert re.search(r"return size_t\(p\.n64\) \* BOX_BYTES \+ size_t\(p\.tail\) "
                     r"\* TAIL_BYTES;", head)
    assert c["TAIL_BYTES"] == 16 * 64 * 2
    assert c["ASUM_REGS"] == 136 and c["MOST_TILES"] == tfb.MHSA_MOST_TILES
    assert _constants("mhsa_bwd.cu")["MOST_TILES"] == tfb.MHSA_BWD_MOST_TILES
    assert re.search(r"const int blocks = \(tiles\(S\) \+ most - 1\) / most;\s*"
                     r"return \(tiles\(S\) \+ blocks - 1\) / blocks;", head)


def test_kernels_are_wgmma_with_no_wmma_left():
    """No WMMA in either source; the scores and dS are wgmma accumulators
    (products from shared memory, then from registers) and the operands
    arrive by TMA; each entry point is bound."""
    head = (_build.CSRC / "attn_sm90.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16" in head
    assert "wgmma.mma_async.sync.aligned.m64n16k16" in head
    assert "cp.async.bulk.tensor.3d" in head
    for name in ("mhsa.cu", "mhsa_bwd.cu"):
        text = (_build.CSRC / name).read_text()
        assert "wmma" not in text and "mma_sync" not in text
        assert '#include "attn_sm90.cuh"' in text
        assert "mma_rs(" in text and "tma_map_3d(" in text
        assert "mst_tpu/ops/fused_block.py" in text
    for sym in ("mst_mhsa", "mst_mhsa_geometry", "mst_mhsa_bwd",
                "mst_mhsa_bwd_geometry"):
        assert sym in _build._SIGNATURES
    assert "attn_sm90.cuh" in {p.name for p in _build._sources()}


# -- the kernels' own summation orders ---------------------------------------


def _carry_fixed_order(c, p):
    """new[j] = sum_q c_q p[q, j] as the kernel orders it: per 64-row tile,
    each thread's rows r and r + 8 (r < 8 of each warp's 16), the warp's 8
    row pairs by the butterfly over lanes 4, 8 and 16 apart, the 4 warps in
    order; then `sum_partials_kernel` over the tiles (8 strided lanes, then
    the lanes in order). f32 throughout; rows past S contribute 0."""
    s, n = p.shape
    rows = -(-s // 64) * 64
    prod = np.zeros((rows, n), np.float32)
    prod[:s] = c[:, None] * p
    parts = []
    for t0 in range(0, rows, 64):
        tile = None
        for w in range(4):
            r0 = t0 + 16 * w
            v = [prod[r0 + q] + prod[r0 + 8 + q] for q in range(8)]
            for o in (1, 2, 4):
                v = [v[q] + v[q ^ o] for q in range(8)]
            tile = v[0] if tile is None else tile + v[0]
        parts.append(tile)
    lanes = [np.zeros(n, np.float32) for _ in range(8)]
    for i, part in enumerate(parts):
        lanes[i % 8] = lanes[i % 8] + part
    out = np.zeros(n, np.float32)
    for lane in lanes:
        out = out + lane
    return out


@pytest.mark.parametrize("s", LENGTHS)
def test_carry_fixed_order_matches_the_f64_sum(s):
    """The kernel's fixed-order carry sum lies within f32 rounding of the
    f64 sum, as does the plain version the kernel is held to on the card."""
    rng = np.random.default_rng(s)
    sc = rng.standard_normal((s, s)).astype(np.float32) * 2
    p = np.exp2(sc - sc.max(-1, keepdims=True)).astype(np.float32)
    carry = rng.random(s).astype(np.float32)
    c = (carry * (1.0 / p.sum(-1))).astype(np.float32)
    ref = (c.astype(np.float64)[:, None] * p.astype(np.float64)).sum(0)
    ours = _carry_fixed_order(c, p)
    # `_mhsa_ref`'s own sum: (r[..., None] * p).sum(-2) in torch
    tp = (torch.from_numpy(c)[:, None] * torch.from_numpy(p)).sum(0)
    _close(ours, ref, dict(atol=1e-6, rtol=1e-5))
    _close(tp.numpy(), ref, dict(atol=1e-6, rtol=1e-5))


def _tree(v):
    """A balanced tree sum of a power-of-two list of f32 values."""
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [np.float32(v[k] + v[k + h]) for k in range(h)]
    return v[0]


def _two_pass_l(s_row):
    """l = sum_j exp2(s_j - m) as the two-pass forward takes it (S > 272):
    per 64-key chunk (a last chunk of <= 16 keys alone) the running max m
    and each lane's share l_t rescaled by exp2(m_old - m_new), then l_t +=
    the chunk's share of lane t (columns 8 k + 2 t, 8 k + 2 t + 1 of its 8
    or 2 column groups k: each pair summed, then the pairs as a tree); the
    four lanes of the row added at the end as the shuffles do. f32."""
    s = s_row.shape[0]
    g = tfb.mhsa_launch(s)
    bounds = [(64 * c, 64) for c in range(g.chunks64)]
    bounds += [(64 * g.chunks64, 16)] * g.tail16
    m = np.float32(-np.inf)
    lanes = np.zeros(4, np.float32)
    for k0, width in bounds:
        cols = np.arange(k0, k0 + width)
        vals = np.where(cols < s, s_row[np.minimum(cols, s - 1)],
                        np.float32(-np.inf)).astype(np.float32)
        new = np.float32(max(m, vals.max()))
        lanes = (lanes * np.exp2(np.float32(m - new))).astype(np.float32)
        p = np.exp2(vals - new).astype(np.float32)
        for t in range(4):
            pairs = [np.float32(p[8 * k + 2 * t] + p[8 * k + 2 * t + 1])
                     for k in range(width // 8)]
            lanes[t] = np.float32(lanes[t] + _tree(pairs))
        m = new
    return m, np.float32((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))


@pytest.mark.parametrize("s", (273, 442, 512))
def test_two_pass_l_matches_the_f64_sum(s):
    """The two-pass forward's rescaled l, and so its LSE m + log2(l), lie
    within f32 rounding of the f64 values from the final max."""
    rng = np.random.default_rng(s)
    row = (rng.standard_normal(s) * 3).astype(np.float32)
    row[-1] = 12.0  # the max arrives in the last chunk: every l rescales
    m, l = _two_pass_l(row)
    assert m == row.max()
    ref = np.exp2(row.astype(np.float64) - row.max()).sum()
    assert abs(l - ref) <= 1e-5 * ref
    assert abs((m + np.log2(l)) - (row.max() + np.log2(ref))) <= 2e-5


# -- the plain versions against mst_tpu ----------------------------------------


def _qkv(seed, n, s, heads, hd=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n * s, 3 * heads * hd)) * 0.5).astype(
        np.float32)


def _tables(seed, s, hd=64):
    """cos / sin [s, hd] f32 of per-pair angles (both columns of a pair
    share one), as `rope_tables` makes them."""
    rng = np.random.default_rng(seed)
    th = np.repeat(rng.random((s, hd // 2)) * 6.0, 2, axis=1)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _jax_mhsa(qkv, s, heads, rope=None, **kw):
    e = qkv.shape[1] // 3
    r = None
    if rope is not None:
        r = (jnp.asarray(rope[0]), jnp.asarray(rope[1]),
             jnp.asarray(jfb._pair_swap_matrix(e // heads), jnp.float32))
    return jfb._mhsa(jnp.asarray(qkv), e, e // heads, heads, jnp.float32,
                     rope=r, S=s, **kw)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s", LENGTHS)
def test_plain_forms_match_mst_tpu_mhsa(s, rope):
    """o with each optional output of `_mhsa_ref` (the LSE, the CLS row,
    the rollout carry, the Abnar factor), with and without RoPE, against
    JAX `_mhsa` on the same inputs in f32."""
    n, heads = 2, 2
    qkv = _qkv(s, n, s, heads)
    tabs = _tables(s + 1, s) if rope else None
    rt = (dict(rope_cos=torch.from_numpy(tabs[0]),
               rope_sin=torch.from_numpy(tabs[1])) if rope else {})
    carry = np.random.default_rng(s + 2).random((n, heads, s)).astype(
        np.float32)
    tq = torch.from_numpy(qkv)
    o, row, lse, new = tfb._mhsa_ref(tq, n, s, heads, want_lse=True,
                                     want_row=True,
                                     carry=torch.from_numpy(carry), **rt)
    jo, jrow, jlse, jnew = _jax_mhsa(qkv, s, heads, tabs, want_row=True,
                                     want_lse=True,
                                     carry_row=jnp.asarray(carry))
    _close(o, jo, what="o")
    _close(row, jrow, what="row")
    _close(lse, np.asarray(jlse).reshape(n * s, heads), what="lse")
    _close(new, jnew, what="carry")
    o2, fac = tfb._mhsa_ref(tq, n, s, heads, want_abnar=True, **rt)
    jo2, jfac = _jax_mhsa(qkv, s, heads, tabs, want_abnar=True)
    _close(o2, jo2, what="o (abnar)")
    _close(fac, jfac, what="abnar")
    # each wrapper on a CPU tensor is its plain version
    _close(tfb.mhsa(tq, n, s, heads, **rt), jo, what="mhsa")
    _close(tfb.mhsa_abnar(tq, n, s, heads, **rt)[1], jfac, what="mhsa_abnar")


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s", LENGTHS)
def test_plain_backward_matches_jax_vjp_of_mhsa(s, rope):
    """`_mhsa_bwd_ref` on the forward's o and LSE against `jax.vjp` of JAX
    `_mhsa` in f32 (where the bf16 rounding points are exact, the same
    derivative), with and without RoPE."""
    n, heads = 2, 2
    qkv = _qkv(10 + s, n, s, heads)
    tabs = _tables(s + 3, s) if rope else None
    rt = (dict(rope_cos=torch.from_numpy(tabs[0]),
               rope_sin=torch.from_numpy(tabs[1])) if rope else {})
    do = np.random.default_rng(s + 4).standard_normal(
        (n * s, heads * 64)).astype(np.float32)
    tq = torch.from_numpy(qkv)
    o, lse = tfb._mhsa_ref(tq, n, s, heads, want_lse=True, **rt)
    dqkv = tfb.mhsa_bwd(tq, o, torch.from_numpy(do), lse, n, s, heads, **rt)
    _, vjp = jax.vjp(lambda u: _jax_mhsa(u, s, heads, tabs), jnp.asarray(qkv))
    ref, = vjp(jnp.asarray(do))
    _close(dqkv, ref)


@pytest.mark.parametrize("s", (201, 257))
def test_train_sublayer_grads_match_jax_grad_of_attn_ref(s):
    """The attention train sub-layer (`_attn_train_fwd` -> `mhsa` with the
    LSE, `_attn_train_bwd` -> `mhsa_bwd`) at the path lengths against
    `jax.grad` of `mst_tpu`'s `_attn_ref` in f32."""
    n, heads, e = 1, 2, 128
    rng = np.random.default_rng(s)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x, g = r(n, s, e), r(n, s, e)
    args = (r(e, scale=0.1, off=1.0), r(e, scale=0.1),
            r(e, 3 * e, scale=0.1), r(3 * e, scale=0.1), r(e, e, scale=0.1),
            r(e, scale=0.1), r(e, scale=0.1, off=1.0))
    tx = torch.from_numpy(x).requires_grad_(True)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tfb.fused_attention_sublayer_train(tx, *targs, heads, 1e-6)
    (y * torch.from_numpy(g)).sum().backward()

    def loss(*a):
        return (jfb._attn_ref(*a, num_heads=heads, eps=1e-6)
                * jnp.asarray(g)).sum()

    ref = jax.grad(loss, tuple(range(8)))(*map(jnp.asarray, (x, *args)))
    for ours, want in zip([tx.grad] + [a.grad for a in targs], ref):
        _close(ours, want, dict(atol=5e-4, rtol=5e-4))


# -- refusals before any launch ---------------------------------------------------


def _no_library():
    raise AssertionError("the kernel library was reached")


REFUSED = [(513, 6, 64, "1 <= S <= 512"), (0, 6, 64, "1 <= S <= 512"),
           (257, 6, 32, "head dim 64"), (257, 6, 128, "head dim 64")]


@pytest.mark.parametrize("s,heads,hd,what", REFUSED)
@pytest.mark.parametrize("kind", ["mhsa", "mhsa_with_row", "mhsa_rollout",
                                  "mhsa_abnar", "mhsa_bwd"])
def test_wrappers_refuse_shapes_before_any_launch(monkeypatch, kind, s, heads,
                                                  hd, what):
    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    n, e = 1, heads * hd
    qkv = torch.zeros((n * s, 3 * e), dtype=torch.bfloat16)
    name = "mhsa_bwd" if kind == "mhsa_bwd" else "mhsa"
    with pytest.raises(ValueError, match=f"{name} needs head dim 64 and "
                                         f"1 <= S <= 512"):
        if kind == "mhsa":
            tfb.mhsa(qkv, n, s, heads)
        elif kind == "mhsa_with_row":
            tfb.mhsa_with_row(qkv, n, s, heads)
        elif kind == "mhsa_rollout":
            tfb.mhsa_rollout(qkv, torch.zeros(n, heads, s), n, s, heads)
        elif kind == "mhsa_abnar":
            tfb.mhsa_abnar(qkv, n, s, heads)
        else:
            o = torch.zeros((n * s, e), dtype=torch.bfloat16)
            tfb.mhsa_bwd(qkv, o, o, torch.zeros(n * s, heads), n, s, heads)


@pytest.mark.parametrize("s", (1, 77, 257, 442, 512))
@pytest.mark.parametrize("kind", ["mhsa", "mhsa_rollout", "mhsa_abnar",
                                  "mhsa_bwd"])
def test_wrappers_accept_kernel_shapes(monkeypatch, kind, s):
    """Every S up to 512 at head dim 64 passes the checks and reaches the
    library (here a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(tfb, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    n, heads = 2, 6
    e = 64 * heads
    qkv = torch.zeros((n * s, 3 * e), dtype=torch.bfloat16)
    with pytest.raises(Reached):
        if kind == "mhsa":
            tfb.mhsa(qkv, n, s, heads, want_lse=True)
        elif kind == "mhsa_rollout":
            tfb.mhsa_rollout(qkv, torch.zeros(n, heads, s), n, s, heads,
                             want_row=True)
        elif kind == "mhsa_abnar":
            tfb.mhsa_abnar(qkv, n, s, heads)
        else:
            o = torch.zeros((n * s, e), dtype=torch.bfloat16)
            tfb.mhsa_bwd(qkv, o, o, torch.zeros(n * s, heads), n, s, heads)
