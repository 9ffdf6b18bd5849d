"""The last two `tools/` counterparts on TMA + wgmma: row 21's split-CLS
core (`attn_variants.cu` `split_cls_kernel<TWO>`) and row 17's
`block_tail` (`block_tail.cu` `block_tail_kernel`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them and transcribe what they do.
- The launch plans the wrappers check and the card-side checks read
  (`bench_attn_split_cls.split_launch`, `bench_block_fusion.
  block_tail_launch`) at every accepted S and at M from 1 up: every query
  row and key in one tile or box, every row in one unit, every weight box
  in one stage of one warpgroup, a block's shared memory, against the
  sources' constants and layouts; the wrappers' refusals before any
  launch.
- The split core's order (the CLS strip of each row summed by the 4 lanes
  of its quad, the row max over the strip, the one-pass or online sum, the
  f32 CLS term added before the division; the CLS row from per-thread key
  sums, warp butterflies and four warp partials) and `block_tail`'s fc1 ->
  GELU -> fc2 accumulation one hidden chunk of 128 columns at a time, each
  against its plain version on bf16 inputs within the card's 2-ulp limit,
  and, inside the tool's layout, against the JAX tool's Pallas kernel
  (interpret mode) at the small size of `tests/test_torch_tools.py`.
`chip_smoke.py` phases 2, 38 and 39 hold the kernels themselves, their
plans (`mst_attn_split_cls_geometry`, `mst_block_tail_geometry`) and their
outputs and times on the card."""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.bench_attn_split_cls as jsc
import tools.bench_block_fusion as jbf
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.tools import bench_attn_split_cls as sc
from mst_tpu_torch.tools import bench_block_fusion as bf

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
SM_SMEM = 233_472  # shared memory of one H100 SM (228 KB)
SPLIT_LENGTHS = tuple(1 + p for p in range(64, 385, 64))
TAIL_ROWS = (1, 63, 64, 65, 771, 32_896)
N, S, E, H = 2, 17, 128, 2  # tests/test_torch_tools.py's small size
REL = 2e-5  # its limit: f32 here, 2e-5 of the largest value


def _source(name):
    return (_build.CSRC / name).read_text()


def _constants(*texts):
    """The `constexpr` ints of sources in order (headers first), comments
    dropped."""
    env = {}
    for text in texts:
        text = re.sub(r"//[^\n]*", "", text)
        for key, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
            expr = (expr.replace("size_t(", "int(")
                    .replace("sizeof(uint64_t)", "8").replace("/", "//"))
            env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def _limit(ref):
    """2 bf16 ulps of the plain output's largest magnitude (the card's)."""
    top = float(ref.abs().max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _no_library():
    raise AssertionError("the kernel library was reached")


class _Reached(Exception):
    pass


def _stand_in():
    raise _Reached


# -- row 21: the split-CLS plan -------------------------------------------------


@pytest.mark.parametrize("s", SPLIT_LENGTHS)
def test_split_plan_covers_every_row_and_key_once(s):
    g = sc.split_launch(s)
    p = s - 1
    assert (g.tile, g.threads) == (64, 128)
    assert g.tiles == g.boxes == p // 64
    # a block walks at most 5 tiles of a (head, slice), shared out evenly
    # over the fewest blocks; the block of the first group takes row 0
    blocks = -(-g.tiles // g.tiles_per_block)
    assert 1 <= g.tiles_per_block <= 5 and blocks == -(-g.tiles // 5)
    owners = np.zeros(s, int)
    owners[0] += 1  # the CLS row
    for b in range(blocks):
        for u in range(min(g.tiles_per_block, g.tiles - b * g.tiles_per_block)):
            q0 = 1 + (b * g.tiles_per_block + u) * 64
            assert q0 + 64 <= s  # exact tiles: no row past S
            owners[q0:q0 + 64] += 1
    assert (owners == 1).all()
    keys = np.zeros(s, int)
    keys[0] += 1  # the CLS key: the strip, and key 0 of the CLS row
    for b in range(g.boxes):
        keys[1 + 64 * b:1 + 64 * b + 64] += 1
    assert (keys == 1).all()
    assert g.passes == (1 if p <= 256 else 2)
    assert g.smem <= SMEM_LIMIT
    # the CLS row's keys: 128 threads, at most 4 keys each
    assert -(-s // g.threads) <= 4


def test_split_plan_mirrors_the_source():
    text = _source("attn_variants.cu")
    body = text[text.index("namespace split {"):text.index("}  // namespace split")]
    c = _constants(_source("gemm_sm90.cuh"), _source("attn_sm90.cuh"),
                   _source("attn_softmax_sm90.cuh"), body)
    assert (c["MAX_P"], c["ONE_PASS_P"], c["CLS_KEYS"]) == (sc.MAX_P,
                                                           sc.ONE_PASS_P, 4)
    assert c["F32_BYTES"] == sc.F32_BYTES
    for pat in (r"L\.k = L\.q \+ 2 \* BOX_BYTES;",
                r"L\.v = L\.k \+ size_t\(nb\) \* BOX_BYTES;",
                r"L\.bar = L\.v \+ size_t\(nb\) \* BOX_BYTES \+ F32_BYTES;",
                r"L\.total = ALIGN \+ L\.bar \+ size_t\(2 \+ nb\) \* "
                r"sizeof\(uint64_t\);",
                r"return P < CHUNK \|\| P % CHUNK != 0 \|\| P > MAX_P;",
                r"tiles_per_block\(a\.S - 1, MOST_TILES\)",
                r"1 \+ \(g \* tpb \+ u\) \* TILE",
                r"1 \+ b \* CHUNK"):
        assert re.search(pat, body), pat
    # at the tools' S = 257: two blocks an SM, as variant D's
    assert 2 * (sc.split_launch(257).smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("s", (1, 2, 64, 66, 200, 258, 449, 513))
def test_split_wrapper_refuses_lengths_before_any_launch(monkeypatch, s):
    monkeypatch.setattr(sc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError, match="P a multiple of 64 from 64 to 384"):
        sc.attn_split_cls(torch.zeros(s, 3 * 384, dtype=torch.bfloat16), 1, s,
                          6)


def test_split_wrapper_refuses_head_dims_before_any_launch(monkeypatch):
    monkeypatch.setattr(sc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError, match="head dim 64"):
        sc.attn_split_cls(torch.zeros(257, 3 * 6 * 32, dtype=torch.bfloat16),
                          1, 257, 6)


@pytest.mark.parametrize("s", SPLIT_LENGTHS)
def test_split_wrapper_accepts_kernel_lengths(monkeypatch, s):
    monkeypatch.setattr(sc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _stand_in)
    with pytest.raises(_Reached):
        sc.attn_split_cls(torch.zeros(2 * s, 3 * 384, dtype=torch.bfloat16), 2,
                          s, 6)


# -- row 21: the split core's order ---------------------------------------------


def _f32(a):
    return np.asarray(a, np.float32)


def _seq(cols):
    """Sum over the last axis one term after another, in f32."""
    acc = np.zeros(cols.shape[:-1], np.float32)
    for j in range(cols.shape[-1]):
        acc = _f32(acc + cols[..., j])
    return acc


def _tree(v):
    """`tree_sum` over the last axis (a power-of-two length), in f32."""
    v = [v[..., k] for k in range(v.shape[-1])]
    w = len(v) // 2
    while w >= 1:
        for k in range(w):
            v[k] = _f32(v[k] + v[k + w])
        w //= 2
    return v[0]


def _butterfly(lanes):
    """Lane 0's value after `v += shfl_xor(v, o)` for o = 16 .. 1 over the
    32 lanes on the last axis."""
    v = _f32(lanes)
    for o in (16, 8, 4, 2, 1):
        v = _f32(v + v[..., np.arange(32) ^ o])
    return v[..., 0]


def _mm(a, b):
    """The tensor-core product's stand-in: f64, rounded to f32 once."""
    return _f32(np.asarray(a, np.float64) @ np.asarray(b, np.float64))


def _split_core(qkv, n, s, heads, scale=sc.SCALE):
    """`split_cls_kernel`'s order, in f32 numpy; P.V's operand P rounded to
    qkv's dtype. Patch rows: the strip s_pc (the quad's four 16-column dot
    products summed as (l0 + l1) + (l2 + l3), times the scale), m from s_pc
    up, p = exp2(s - m), each quad lane's column pairs summed as trees box
    by box (one pass, P <= 256) or the online sum rescaled as m grows (two
    passes), then the quad, + p_pc; o = (P.V + p_pc v_c) / l. The CLS row:
    thread t scores keys t, t + 128, ..; the max and the sum by warp
    butterflies and the four warps' values; warp w sums bf16(p) v over keys
    w, w + 4, ..; o = ((w0 + w1) + (w2 + w3)) / l. Boxes are 64 keys (the
    last one narrower where P % 64 != 0, as the small JAX size needs)."""
    dt = qkv.dtype
    p_ = s - 1
    t = qkv.float().reshape(n, s, 3, heads, 64).permute(2, 0, 3, 1, 4).numpy()
    q, k, v = t  # [n, heads, s, 64]
    sc32 = np.float32(scale)

    def to_dt(a):
        return torch.from_numpy(_f32(a)).to(dt).float().numpy()

    qp, kp, vp = q[..., 1:, :], k[..., 1:, :], v[..., 1:, :]
    kc, vc = k[..., :1, :], v[..., :1, :]
    prod = _f32(qp * kc)
    quad = [_seq(prod[..., 16 * j:16 * j + 16]) for j in range(4)]
    spc = _f32(_f32(_f32(quad[0] + quad[1]) + _f32(quad[2] + quad[3])) * sc32)
    s_pp = _f32(_mm(qp, kp.swapaxes(-1, -2)) * sc32)
    boxes = [(b0, min(p_, b0 + 64)) for b0 in range(0, p_, 64)]

    def lane_sums(p, width):
        """Each quad lane's tree over its column pairs of one box."""
        cols = np.zeros(p.shape[:-1] + (64,), np.float32)
        cols[..., :width] = p
        return [_tree(np.stack([_f32(cols[..., 8 * j + 2 * ql]
                                     + cols[..., 8 * j + 2 * ql + 1])
                                for j in range(8)], -1)) for ql in range(4)]

    m = spc.copy()
    lanes = [np.zeros_like(spc) for _ in range(4)]
    if p_ <= sc.ONE_PASS_P:
        m = np.maximum(m, s_pp.max(-1))
        for b0, b1 in boxes:
            part = lane_sums(np.exp2(_f32(s_pp[..., b0:b1] - m[..., None])),
                             b1 - b0)
            lanes = [_f32(a + b) for a, b in zip(lanes, part)]
    else:
        for b0, b1 in boxes:
            x = np.maximum(m, s_pp[..., b0:b1].max(-1))
            part = lane_sums(np.exp2(_f32(s_pp[..., b0:b1] - x[..., None])),
                             b1 - b0)
            lanes = [_f32(_f32(a * np.exp2(_f32(m - x))) + b)
                     for a, b in zip(lanes, part)]
            m = x
    l = _f32(_f32(lanes[0] + lanes[1]) + _f32(lanes[2] + lanes[3]))
    ppc = np.exp2(_f32(spc - m))
    l = _f32(l + ppc)
    pp = to_dt(np.exp2(_f32(s_pp - m[..., None])))
    o_p = _f32(_f32(_mm(pp, vp) + _f32(ppc[..., None] * vc)) / l[..., None])

    # the CLS row
    s_c = _f32(_mm(q[..., :1, :], k.swapaxes(-1, -2))[..., 0, :] * sc32)
    keys = np.full(s_c.shape[:-1] + (4 * 128,), -np.inf, np.float32)
    keys[..., :s] = s_c
    by_thread = keys.reshape(s_c.shape[:-1] + (4, 128))  # [.., i, t]
    warp_max = by_thread.max(-2).reshape(s_c.shape[:-1] + (4, 32)).max(-1)
    mx = np.maximum(np.maximum(warp_max[..., 0], warp_max[..., 1]),
                    np.maximum(warp_max[..., 2], warp_max[..., 3]))
    pk = np.exp2(_f32(keys - mx[..., None]))
    pk[..., s:] = 0.0
    per_thread = _seq(np.moveaxis(pk.reshape(s_c.shape[:-1] + (4, 128)), -2,
                                  -1))  # [.., t]: keys t, t + 128, ..
    red = _butterfly(per_thread.reshape(per_thread.shape[:-1] + (4, 32)))
    lc = _f32(_f32(red[..., 0] + red[..., 1]) + _f32(red[..., 2] + red[..., 3]))
    pcb = to_dt(pk[..., :s])
    part = []
    for w in range(4):
        acc = np.zeros(vc.shape[:-2] + (64,), np.float32)
        for j in range(w, s, 4):
            acc = _f32(acc + _f32(pcb[..., j, None] * v[..., j, :]))
        part.append(acc)
    o_c = _f32(_f32(_f32(part[0] + part[1]) + _f32(part[2] + part[3]))
               / lc[..., None])
    o = np.concatenate([o_c[..., None, :], o_p], -2)  # [n, heads, s, 64]
    return torch.from_numpy(o).to(dt).permute(0, 2, 1, 3).reshape(
        n * s, heads * 64)


@pytest.mark.parametrize("s", SPLIT_LENGTHS)
def test_split_order_matches_split_ref_on_bf16(s):
    """The kernel's order on bf16 qkv against the plain version within the
    card's limit, the CLS row included, one pass and two."""
    n, heads = 2, 2
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((n * s, 3 * 64 * heads))
                           .astype(np.float32)).to(torch.bfloat16)
    ours = _split_core(qkv, n, s, heads).float()
    ref = sc.split_ref(qkv, n, s, heads).float()
    assert torch.isfinite(ours).all()
    assert (ours - ref).abs().max().item() <= _limit(ref)
    # the CLS row on its own (one row of 64 a (slice, head))
    rows = torch.arange(n) * s
    assert ((ours[rows] - ref[rows]).abs().max().item()
            <= _limit(ref[rows]))


@pytest.fixture(scope="module")
def split_case():
    rng = np.random.default_rng(1)
    qkv = (rng.standard_normal((N, S, 3 * E)) * 0.3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(N=N, S=S, E=E, H=H, HD=E // H).items():
            mp.setattr(jsc, name, value)
        out = np.asarray(jsc.run(jsc._mhsa_split, jnp.asarray(qkv)))
    return qkv, out


def test_split_order_matches_the_jax_tool(split_case, monkeypatch):
    """The tool's split layout with the kernel's order as its core, in f32,
    against the JAX tool's `_mhsa_split` Pallas kernel."""
    qkv, ref = split_case
    monkeypatch.setattr(sc, "attn_split_cls", _split_core)
    t = torch.from_numpy(qkv).reshape(N * S, 3 * E)
    out = sc.LAYOUTS["split"](t, N, S, H).reshape(N, S, E).numpy()
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max()


# -- row 17: the block_tail plan ------------------------------------------------


def _tail_box(w, i, j, kb=bf.TAIL_KB):
    """`box_of`: box j of a unit's stage i for warpgroup w, (weight,
    first column, first k row); boxes of kb k rows."""
    proj, fc1, fc2 = 384 // kb, 384 // (3 * kb), 128 // kb
    if i < proj:
        return "wproj", w * 192 + 64 * j, kb * i
    c, r = divmod(i - proj, fc1 + fc2)
    if r < fc1:
        return "w1", c * 128 + w * 64, kb * (3 * r + j)
    return "w2", w * 192 + 64 * j, c * 128 + kb * (r - fc1)


@pytest.mark.parametrize("m", TAIL_ROWS)
@pytest.mark.parametrize("sms", (132, 114))
def test_tail_plan_covers_every_row_once(m, sms):
    g = bf.block_tail_launch(m, sms)
    assert (g.rows, g.threads, g.consumers) == (64, 384, 2)
    assert g.ring * g.stage == 48 * 1024 and g.ring >= 2
    assert g.units == -(-m // 64) and g.grid == min(g.units, sms)
    rows = np.zeros(g.units * 64, int)
    for cta in range(g.grid):
        for u in range(cta, g.units, g.grid):
            rows[64 * u:64 * u + 64] += 1
    assert (rows == 1).all()  # rows past M are zero-filled, never stored
    assert g.smem <= SMEM_LIMIT
    # one CTA an SM: a second would not fit
    assert 2 * (g.smem + 1024) > SM_SMEM


def test_tail_stages_cover_every_weight_once():
    """A unit's stages over both warpgroups read each [kb][64] box of
    wproj, w1 and w2 once; fc1 of a chunk comes before its fc2, whose k
    rows are that chunk's hidden columns."""
    g = bf.block_tail_launch(32_896)
    kb = bf.TAIL_KB
    assert g.stage == 3 * kb * 64 * 2
    assert g.unit_stages == 384 // kb + 12 * (384 // (3 * kb) + 128 // kb)
    seen = {}
    for w in range(2):
        last_fc1 = {}
        for i in range(g.unit_stages):
            for j in range(3):
                name, col, row = _tail_box(w, i, j)
                seen[(name, row, col)] = seen.get((name, row, col), 0) + 1
                if name == "w1":
                    last_fc1[col // 128] = i
                if name == "w2":
                    chunk = row // 128
                    assert last_fc1[chunk] < i
                    # fc1's columns of this chunk are fc2's k rows
                    assert 0 <= row - 128 * chunk < 128
    shapes = {"wproj": (384, 384), "w1": (384, 1536), "w2": (1536, 384)}
    want = {(name, r, c): 1 for name, (k, n) in shapes.items()
            for r in range(0, k, kb) for c in range(0, n, 64)}
    assert seen == want


def test_tail_plan_mirrors_the_source():
    text = _source("block_tail.cu")
    c = _constants(text)
    g = bf.block_tail_launch(32_896)
    assert (c["E"], c["F"], c["ROWS"], c["CHUNK"], c["KB"]) == (
        bf.E, bf.FF, bf.TAIL_ROWS, bf.TAIL_CHUNK, bf.TAIL_KB)
    assert (c["THREADS"], c["RING"], c["STAGE"], c["UNIT_STAGES"]) == (
        g.threads, g.ring, g.stage, g.unit_stages)
    # the registers after setmaxnreg fit the SM's 65,536
    assert (128 * c["PRODUCER_REGS"] + 2 * 128 * c["CONSUMER_REGS"]
            <= 65_536)
    assert c["SMEM_BYTES"] == g.smem == 230_480
    for pat in (r"if \(i < PROJ_STAGES\) return \{W_PROJ, w \* HALF \+ 64 \* j, KB \* i\};",
                r"if \(r < FC1_STAGES\) return \{W_FC1, c \* CHUNK \+ w \* 64, KB \* \(3 \* r \+ j\)\};",
                r"return \{W_FC2, w \* HALF \+ 64 \* j, c \* CHUNK \+ KB \* \(r - FC1_STAGES\)\};",
                r"product\(ring, PROJ_STAGES, it, d,",
                r"product\(ring, FC1_STAGES, it, a,",
                r"product\(ring, FC2_STAGES, it, d,",
                r"mbar_init\(&ring_of\(w\)\.empty\[s\], 4\);"):
        assert re.search(pat, text), pat


@pytest.mark.parametrize("m", (0, -1))
def test_tail_wrapper_refuses_before_any_launch(monkeypatch, m):
    monkeypatch.setattr(bf, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError):
        bf.block_tail_launch(m)
    p = bf.params("cpu", 256)  # E = 256: not the kernel's width
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_tail is built for"):
        bf.block_tail(x, x, p.wproj, p.bproj, p.ln2s, p.ln2b, p.w1, p.b1, p.w2,
                      p.b2)


@pytest.mark.parametrize("m", (1, 771, 32_896))
def test_tail_wrapper_accepts_any_rows(monkeypatch, m):
    monkeypatch.setattr(bf, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _stand_in)
    p = bf.params("cpu")
    x = torch.zeros(m, bf.E, dtype=torch.bfloat16)
    with pytest.raises(_Reached):
        bf.block_tail(x, x, p.wproj, p.bproj, p.ln2s, p.ln2b, p.w1, p.b1, p.w2,
                      p.b2)


# -- row 17: block_tail's order -------------------------------------------------


def _gelu_sigmoid(v):
    """The kernel's `gelu_tanh`: v sigmoid(2u), u = sqrt(2/pi) (v + 0.044715
    v^3), which is 0.5 v (1 + tanh u)."""
    u = 0.7978845608028654 * (v + 0.044715 * v * v * v)
    return v / (1.0 + torch.exp(-2.0 * u))


def _tail_chunks(o, x2, wproj, bproj, ln_s, ln_b, w1, b1, w2, b2,
                 eps=bf.EPS, chunk=bf.TAIL_CHUNK):
    """`block_tail_kernel`'s order: x1 = bf16(x + (bproj + o.wproj)), h =
    bf16(LN2(x1)); fc2's f32 accumulators start from b2, then one hidden
    chunk of `chunk` columns at a time, a = bf16(gelu_tanh(bf16(b1 +
    h.w1[:, chunk]))) (as v sigmoid(2u)) and acc += a.w2[chunk, :], so the
    [M, F] hidden never exists whole; out = bf16(x1 + acc)."""
    dt = x2.dtype
    x1 = tfb._gemm_residual_ref(o, wproj, bproj, None, x2)
    h = tfb._ln(x1, ln_s, ln_b, eps).to(dt)
    acc = tfb._f(b2).expand(x2.shape)
    for c0 in range(0, w1.shape[1], chunk):
        pre = (tfb._f(b1[c0:c0 + chunk]) + tfb._mm(h, w1[:, c0:c0 + chunk])
               ).to(dt)
        a = _gelu_sigmoid(tfb._f(pre)).to(dt)
        acc = acc + tfb._mm(a, w2[c0:c0 + chunk])
    return (tfb._f(x1) + acc).to(dt)


@pytest.mark.parametrize("m", (1, 771))
def test_tail_order_matches_block_tail_ref_on_bf16(m):
    """The chunked order at the kernel's widths on bf16 rows against the
    plain version within the card's limit, with nonzero biases and LN
    operands."""
    rng = np.random.default_rng(m)
    p = bf.params("cpu")
    for name in ("bproj", "ln2b", "b1", "b2"):
        t = getattr(p, name)
        setattr(p, name, torch.from_numpy(
            (0.1 * rng.standard_normal(t.shape)).astype(np.float32)))
    p.ln2s = torch.from_numpy((1 + 0.1 * rng.standard_normal(bf.E))
                              .astype(np.float32))

    def rows():
        return torch.from_numpy((0.3 * rng.standard_normal((m, bf.E)))
                                .astype(np.float32)).to(torch.bfloat16)

    args = (rows(), rows(), p.wproj, p.bproj, p.ln2s, p.ln2b, p.w1, p.b1, p.w2,
            p.b2)
    ours = _tail_chunks(*args).float()
    ref = bf.block_tail_ref(*args).float()
    assert torch.isfinite(ours).all()
    assert (ours - ref).abs().max().item() <= _limit(ref)


@pytest.fixture(scope="module")
def block_case():
    rng = np.random.default_rng(4)
    ff = 4 * E
    x = (rng.standard_normal((N, S, E)) * 0.3).astype(np.float32)

    def r(*shape, scale=0.05, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    attn = [r(1, E, scale=0.1, off=1.0), r(1, E, scale=0.1), r(E, 3 * E),
            r(1, 3 * E, scale=0.1), r(E, E), r(1, E, scale=0.1)]
    mlp = [r(1, E, scale=0.1, off=1.0), r(1, E, scale=0.1), r(E, ff),
           r(1, ff, scale=0.1), r(ff, E), r(1, E, scale=0.1)]
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(N=N, S=S, E=E, H=H, HD=E // H,
                                FF=ff).items():
            mp.setattr(jbf, name, value)
        out = np.asarray(jbf.call(jbf._block_kernel, jnp.asarray(x),
                                  [jnp.asarray(o) for o in attn + mlp]))
    names = ("ln1s", "ln1b", "wqkv", "bqkv", "wproj", "bproj", "ln2s", "ln2b",
             "w1", "b1", "w2", "b2")
    p = dict(zip(names, (torch.from_numpy(o.reshape(-1) if o.shape[0] == 1
                                          else o) for o in attn + mlp)))
    return x, SimpleNamespace(**p), out


def test_tail_order_matches_the_jax_tool(block_case, monkeypatch):
    """The tool's 3-launch block with the chunked order as its tail (4
    chunks of 128 at F = 512), in f32, against the JAX tool's
    `_block_kernel` Pallas kernel."""
    x, p, ref = block_case
    monkeypatch.setattr(bf, "block_tail", _tail_chunks)
    out = bf.LAYOUTS["block"](torch.from_numpy(x), p, H).numpy()
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max()
    assert jax.default_backend() == "cpu"
