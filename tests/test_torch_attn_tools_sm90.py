"""The `tools/` attention cores on TMA + wgmma with the scores in registers
(queue B rows 18 and 19): `attn_variants.cu` `variant_kernel<V, TWO>` and
`attn_i8.cu` `attn_i8_kernel<INT8_PV, TWO>`, on the softmax of
`attn_softmax_sm90.cuh`.

There is no card here, so the kernels do not run: these tests hold what
surrounds them and transcribe what they do in registers.
- The launch plans the wrappers check and the card-side checks read
  (`bench_attn_softmax.variant_launch`, `bench_attn_i8.i8_launch`) at
  every S from 1 to 512: every query row in one tile, every key in one
  chunk, a block's shared memory, C's transposed V codes (`vt`), against
  the sources' layouts; the wrappers' refusals before any launch.
- Row 19 C's on-chip V transpose (the 64-byte-swizzled TMA boxes of V's
  codes -> vt [64][vt_ld] by byte permutes, the keys in the k positions
  that make each A register a thread's own codes) and the P codes from the
  f32 accumulator fragments (the low byte of p + 1.5 * 2^23, four to a
  word), then m16n8k32 by its fragment definition, held exactly to pq . vq
  on random codes at S = 77, 201 and 257 with the keys past S zero.
- The variant hooks in the one-pass order (each thread's column pairs
  summed as trees, the 4 lanes of a row, p / l before P or o / l after)
  against `core_ref` on bf16 inputs within the card's 2-ulp limit, and,
  inside the tool's sub-layer, against the JAX tool's Pallas kernel
  (interpret mode) at the small size of `tests/test_torch_tools.py`.
`chip_smoke.py` phases 2 and 38 hold the kernels themselves, their plans
(`mst_attn_variant_geometry`, `mst_attn_i8_geometry`) and their outputs on
the card."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.bench_attn_softmax as jsm
from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.tools import bench_attn_i8 as bi
from mst_tpu_torch.tools import bench_attn_softmax as sm

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
SM_SMEM = 233_472  # shared memory of one H100 SM (228 KB)
CODE_LENGTHS = (77, 201, 257)


def _body(text, name):
    """The source text of the function `name` up to the next top-level
    definition."""
    start = text.index(name)
    nxt = re.search(r"\n(?:template <|extern \"C\"|// ---- )", text[start:])
    return text[start:start + (nxt.start() if nxt else len(text))]


# -- launch plans --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["variant", "B", "C"])
def test_plans_cover_every_row_and_key_once(kind):
    for s in range(1, 513):
        g = sm.variant_launch(s) if kind == "variant" else bi.i8_launch(s, kind)
        assert (g.tile, g.threads) == (64, 128)
        assert (g.tiles - 1) * 64 < s <= g.tiles * 64
        # a block walks at most 5 tiles of a (head, slice), shared out
        # evenly over the fewest blocks
        blocks = -(-g.tiles // g.tiles_per_block)
        assert 1 <= g.tiles_per_block <= 5 and blocks == -(-g.tiles // 5)
        assert (blocks - 1) * g.tiles_per_block < g.tiles
        owners = np.zeros(s, int)
        for b in range(blocks):
            for u in range(min(g.tiles_per_block, g.tiles - b * g.tiles_per_block)):
                q0 = (b * g.tiles_per_block + u) * 64
                owners[q0:min(s, q0 + 64)] += 1
        assert (owners == 1).all()
        keys = np.zeros(s, int)
        widths = [64] * g.chunks64 + [16] * g.tail16
        for c, w in enumerate(widths):
            assert 64 * c < s
            keys[64 * c:min(s, 64 * c + w)] += 1
        assert (keys == 1).all()
        assert g.passes == (1 if s <= 272 else 2)
        assert g.smem <= SMEM_LIMIT
        if kind == "C":
            covered = 64 * g.chunks64 + 16 * g.tail16
            assert g.vt_ld % 16 == 0 and (g.vt_ld // 16) % 2 == 1
            assert g.vt_ld - 16 >= covered and (g.vt_ld - 16) % 32 == 0
            assert g.vt_ld - 16 - covered < 32
    # the tools' S = 257: two blocks of the bf16 core an SM, three of the
    # int8 ones
    assert 2 * (sm.variant_launch(257).smem + 1024) <= SM_SMEM
    for kind in "BC":
        assert 3 * (bi.i8_launch(257, kind).smem + 1024) <= SM_SMEM


def _constants(*names):
    """The namespace-level `constexpr` ints of the sources in order
    (headers first)."""
    env = {}
    for name in names:
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for key, expr in re.findall(
                r"^constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text,
                re.M):
            expr = expr.replace("size_t(", "int(").replace("/", "//")
            env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def test_plans_mirror_the_sources():
    c = _constants("gemm_sm90.cuh", "attn_sm90.cuh", "attn_softmax_sm90.cuh")
    assert (c["TILE"], c["CHUNK"], c["TAIL"], c["THREADS"], c["MAX_S"]) == (
        64, 64, 16, 128, 512)
    assert c["ONE_PASS_MAX"] == 272 and c["MOST_TILES"] == 5
    i8 = _constants("gemm_sm90.cuh", "attn_sm90.cuh", "attn_i8.cu")
    assert (i8["BOX8"], i8["TAIL8"], i8["SW64_GROUP"]) == (4096, 1024, 512)
    var = (_build.CSRC / "attn_variants.cu").read_text()
    for pat in (r"L\.k = L\.q \+ 2 \* BOX_BYTES;",
                r"L\.v = L\.k \+ operand_bytes\(p\);",
                r"L\.bar = L\.v \+ operand_bytes\(p\);",
                r"L\.total = ALIGN \+ L\.bar \+ size_t\(2 \+ p\.boxes\) \* "
                r"sizeof\(uint64_t\);",
                r"tiles_per_block\(a\.S, MOST_TILES\)",
                r"a\.S > ONE_PASS_MAX \? launch_variant<V, true>"):
        assert re.search(pat, var), pat
    src = (_build.CSRC / "attn_i8.cu").read_text()
    for pat in (r"L\.o = L\.q \+ 2 \* BOX8;",
                r"L\.k = L\.o \+ BOX_BYTES;",
                r"L\.v = L\.k \+ codes_bytes\(p\);",
                r"L\.vt = L\.v \+ \(int8_pv \? codes_bytes\(p\) : "
                r"operand_bytes\(p\)\);",
                r"L\.bar = L\.vt \+ \(int8_pv \? size_t\(HD\) \* vt_ld\(p\) : 0\);",
                r"L\.total = ALIGN \+ L\.bar \+ size_t\(2 \+ p\.boxes\) \* "
                r"sizeof\(uint64_t\);",
                r"return \(p\.n64 \* CHUNK \+ p\.tail \* TAIL \+ 31\) & ~31;",
                r"return vt_keys\(p\) \+ 16;",
                r"const bool two = S > ONE_PASS_MAX;"):
        assert re.search(pat, src), pat


def test_kernels_are_wgmma_with_no_wmma_left():
    """The cores of rows 18, 19 and 21 and row 17's `block_tail` hold wgmma
    products on TMA boxes and no WMMA, in the whole of their sources; the
    int8 one no bf16 product in its scores; each entry point is bound."""
    head = (_build.CSRC / "attn_softmax_sm90.cuh").read_text()
    assert '#include "attn_sm90.cuh"' in head and "h2exp2(" in head
    var = (_build.CSRC / "attn_variants.cu").read_text()
    assert "wmma" not in var.lower()
    body = _body(var, "variant_kernel(")
    assert "scores(" in body and "pv_sync(" in body
    assert "tma_load_3d(" in body and "pv(acc" in body
    # row 21: the patch tiles on the same pieces, the CLS row in the launch
    split = _body(var, "split_cls_kernel(")
    for piece in ("scores(", "pv_sync(", "pv(acc", "tma_load_3d(", "cls_row(",
                  "quad_sum("):
        assert piece in split, piece
    assert "mma" not in _body(var, "cls_row(")  # no wgmma under its branch
    tail = (_build.CSRC / "block_tail.cu").read_text()
    assert "wmma" not in tail.lower() and "cp_async16" not in tail
    for piece in ("wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16",
                  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                  "setmaxnreg.inc", "setmaxnreg.dec",
                  "fence_async_smem()", "bar.sync 1"):
        assert piece in tail, piece
    src = (_build.CSRC / "attn_i8.cu").read_text()
    assert "wmma" not in src and "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8" in src
    assert "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8" in src
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in src and "__byte_perm(" in src
    assert "ex2(__fadd_rn(__fsub_rn(s, m), LOG2_127))" in head
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    for sym in ("mst_attn_variant", "mst_attn_variant_geometry", "mst_attn_i8",
                "mst_attn_i8_geometry", "mst_attn_split_cls",
                "mst_attn_split_cls_geometry", "mst_block_tail",
                "mst_block_tail_geometry"):
        assert sym in _build._SIGNATURES
    assert len(_build._SIGNATURES["mst_attn_i8"]) == 11  # p_out added
    assert "attn_softmax_sm90.cuh" in {p.name for p in _build._sources()}


def _no_library():
    raise AssertionError("the kernel library was reached")


@pytest.mark.parametrize("s", (0, 513, 1370))
@pytest.mark.parametrize("kind", ["variant", "B", "C"])
def test_wrappers_refuse_lengths_before_any_launch(monkeypatch, kind, s):
    monkeypatch.setattr(sm, "_on_cuda", lambda t: True)
    monkeypatch.setattr(bi, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    n, heads = 1, 6
    e = 64 * heads
    with pytest.raises(ValueError, match=r"takes 1 <= S <= 512"):
        if kind == "variant":
            sm.attn_variant(torch.zeros(max(n * s, 1), 3 * e,
                                        dtype=torch.bfloat16), n, s, heads, "D")
        else:
            q8 = torch.zeros(max(n * s, 1), (2 if kind == "B" else 3) * e,
                             dtype=torch.int8)
            v = (torch.zeros(max(n * s, 1), e, dtype=torch.bfloat16)
                 if kind == "B" else None)
            bi.attn_i8(q8, v, n, s, heads)


def test_i8_wrapper_returns_codes_for_c_only(monkeypatch):
    monkeypatch.setattr(bi, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError, match="variant C only"):
        bi.attn_i8(torch.zeros(257, 768, dtype=torch.int8),
                   torch.zeros(257, 384, dtype=torch.bfloat16), 1, 257, 6,
                   want_p=True)


def test_variant_wrapper_refuses_head_dims_before_any_launch(monkeypatch):
    monkeypatch.setattr(sm, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    with pytest.raises(ValueError, match="head dim 64"):
        sm.attn_variant(torch.zeros(257, 3 * 6 * 32, dtype=torch.bfloat16),
                        1, 257, 6, "D")


@pytest.mark.parametrize("s", (1, 77, 257, 273, 400, 512))
@pytest.mark.parametrize("kind", ["variant", "B", "C"])
def test_wrappers_accept_kernel_lengths(monkeypatch, kind, s):
    """Every S up to 512 (the old WMMA kernel took 400 for row 18) passes
    the checks and reaches the library (a stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(sm, "_on_cuda", lambda t: True)
    monkeypatch.setattr(bi, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    n, heads = 2, 6
    e = 64 * heads
    with pytest.raises(Reached):
        if kind == "variant":
            sm.attn_variant(torch.zeros(n * s, 3 * e, dtype=torch.bfloat16),
                            n, s, heads, "A", want_p=True)
        else:
            q8 = torch.zeros(n * s, (2 if kind == "B" else 3) * e,
                             dtype=torch.int8)
            v = torch.zeros(n * s, e, dtype=torch.bfloat16) if kind == "B" else None
            bi.attn_i8(q8, v, n, s, heads, want_p=kind == "C")


# -- row 19 C: the V transpose and the P-code repack, in numpy ------------------


def _byte_perm(x, y, sel):
    """`__byte_perm(x, y, sel)` on uint32 arrays (sel may vary by lane):
    byte i of the result is byte (sel >> 4 i) & 7 of y:x."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF
                                                       for i in range(4)]
    src = np.broadcast_arrays(*src)
    sel = np.broadcast_to(np.asarray(sel, np.uint64), src[0].shape)
    out = np.zeros(src[0].shape, np.uint64)
    for i in range(4):
        pick = ((sel >> np.uint64(4 * i)) & np.uint64(7)).astype(np.int64)
        out |= np.choose(pick, src) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _sw64(r, b):
    """Byte b of row r of a [rows][64 bytes] box with 64-byte swizzle."""
    return r * 64 + ((((b >> 4) ^ ((r >> 1) & 3)) << 4) | (b & 15))


def _v_boxes(vq, s):
    """The bytes TMA lands for one (slice, head)'s V codes vq [s, 64]: a
    [64][64] box a 64-key chunk, a [16][64] tail box, rows past s zero."""
    g = bi.i8_launch(s, "C")
    boxes = np.zeros(g.chunks64 * 4096 + g.tail16 * 1024, np.uint8)
    for b in range(g.chunks64 + g.tail16):
        for r in range(64 if b < g.chunks64 else 16):
            j = 64 * b + r
            if j < s:
                boxes[4096 * b + _sw64(r, np.arange(64))] = vq[j].view(np.uint8)
    return boxes


def _position(c):
    """The k position of P.V of chunk column c (`transpose_v`)."""
    j, o = c // 8, c % 8
    return 32 * (j // 4) + 16 * ((j // 2) % 2) + 4 * (o // 2) + 2 * (j % 2) + o % 2


def _transpose_v(boxes, s):
    """`transpose_v`: vt [64][vt_ld] bytes, 4 k positions x 4 columns a
    step (the keys 8j + 2u, + 1, 8 (j + 1) + 2u, + 1) by the kernel's 8 byte
    permutes; keys past the chunks zero."""
    g = bi.i8_launch(s, "C")
    ld, keys = g.vt_ld, g.vt_ld - 16
    covered = 64 * g.chunks64 + 16 * g.tail16
    vt = np.zeros(64 * ld, np.uint8)
    words = boxes.view(np.uint32)
    for u in range((keys // 4) * 16):
        k0, d0 = 4 * (u // 16), 4 * (u % 16)
        r = k0 % 64
        j0 = k0 - r + 8 * (4 * (r // 32) + 2 * ((r // 16) & 1)) + 2 * ((r // 4) & 3)
        w = []
        for i in range(4):
            j = j0 + (i & 1) + 8 * (i >> 1)
            w.append(int(words[((j // 64) * 4096 + _sw64(j % 64, d0)) // 4])
                     if j < covered else 0)
        t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
        t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
        for k, o in enumerate((_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                               _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))):
            at = (d0 + k) * ld + k0
            vt[at:at + 4] = np.array([o], np.uint32).view(np.uint8)
    return vt.reshape(64, ld)


def _frag(t, i):
    """(row offset in the warp's 16, column) of accumulator i of lane
    t % 4's quad position: the m64nNk16 D fragment of a warp."""
    return 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (t & 3) + (i & 1)


def _codes4(v0, v1, v2, v3):
    """`codes4`: the low byte of each p + 1.5 * 2^23 in f32 (rint, half to
    even), four of them as the bytes of a word, by the kernel's permutes."""
    r = [(np.asarray(v, np.float32) + np.float32(12582912.0)).view(np.uint32)
         for v in (v0, v1, v2, v3)]
    return _byte_perm(_byte_perm(r[0], r[1], 0x0040), _byte_perm(r[2], r[3], 0x0040),
                      0x5410)


def _repack(p, key0, r):
    """`codes_a`' A fragments of one warp for a chunk of 2r keys (r = 32 or
    8 f32 registers a lane), p [16 rows][keys] the f32 p: for each k step,
    a [32 lanes][4] uint32 of each lane's own registers."""
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    reg = np.zeros((32, r), np.float32)
    for i in range(r):
        dr, col = _frag(t, i)
        reg[:, i] = p[g + dr, key0 + col]
    frags = []
    for kc in range((r + 8) // 16):
        i = 16 * kc
        a = [_codes4(reg[:, i], reg[:, i + 1], reg[:, i + 4], reg[:, i + 5]),
             _codes4(reg[:, i + 2], reg[:, i + 3], reg[:, i + 6], reg[:, i + 7])]
        if r > 8:
            a += [_codes4(reg[:, i + 8], reg[:, i + 9], reg[:, i + 12], reg[:, i + 13]),
                  _codes4(reg[:, i + 10], reg[:, i + 11], reg[:, i + 14], reg[:, i + 15])]
        else:
            a += [np.zeros(32, np.uint32)] * 2
        frags.append(np.stack(a, 1))
    return frags


def _bytes(w):
    return np.asarray(w, np.uint32).view(np.int8).reshape(*np.shape(w), 4)


def _mma_16832(acc, a, vt, key0, n0):
    """acc [32 lanes][4] += the m16n8k32 product of the A fragments a and
    the B fragments `ldmatrix` gives from vt rows n0.. at keys key0.., by
    the instruction's fragment definition."""
    lanes = np.arange(32)
    g, t = lanes[:, None] >> 2, lanes[:, None] & 3
    b4 = np.arange(4)
    amat = np.zeros((16, 32), np.int64)
    ab = _bytes(a)  # [32 lanes][4 registers][4 bytes]
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        amat[g + dr, dk + 4 * t + b4] = ab[:, reg, :]
    # ldmatrix: lane (g, t) of matrix 0 / 1 holds row n0 + g, bytes 4t ..
    # of the 16 bytes at key0 / key0 + 16
    vt8 = vt.view(np.int8)
    bmat = np.zeros((32, 8), np.int64)
    for dk in (0, 16):
        bmat[dk + 4 * t + b4, g] = vt8[n0 + g, key0 + dk + 4 * t + b4]
    prod = amat @ bmat
    e = np.arange(4)
    acc += prod[g + 8 * (e >> 1), 2 * t + (e & 1)]


@pytest.mark.parametrize("s", CODE_LENGTHS)
def test_c_transpose_and_repack_give_pq_dot_vq_exactly(s):
    rng = np.random.default_rng(s)
    g = bi.i8_launch(s, "C")
    vq = rng.integers(-127, 128, (s, 64)).astype(np.int8)
    vt = _transpose_v(_v_boxes(vq, s), s)
    keys = g.vt_ld - 16
    # vt holds V^T in the k positions of each chunk, zero past S; the pad
    # columns are never read
    want = np.zeros((64, keys), np.int8)
    for j in range(s):
        want[:, 64 * (j // 64) + _position(j % 64)] = vq[j]
    np.testing.assert_array_equal(vt[:, :keys].view(np.int8), want)
    assert sorted(_position(c) for c in range(64)) == list(range(64))
    # p in [0, 127] as the softmax leaves it (keys past S: p = 0); half the
    # rows on .5 ties, which rint takes to the even code
    rows = 64 * g.tiles
    p = rng.uniform(0.0, 127.0, (rows, 64 * g.chunks64 + 16 * g.tail16)).astype(np.float32)
    p[::2, ::3] = np.floor(p[::2, ::3]) + 0.5
    p[:, s:] = 0.0
    pq = np.rint(p).astype(np.int64)
    ref = pq[:, :s] @ vq.astype(np.int64)
    for w0 in range(0, rows, 16):  # each warp's 16 rows
        acc = np.zeros((32, 32), np.int64)  # [lane][acc register]
        for b in range(g.chunks64 + g.tail16):
            r = 32 if b < g.chunks64 else 8
            for kc, a in enumerate(_repack(p[w0:w0 + 16], 64 * b, r)):
                for j in range(8):  # n tiles of 8 columns
                    sub = np.zeros((32, 4), np.int64)
                    _mma_16832(sub, a, vt, 64 * b + 32 * kc, 8 * j)
                    acc[:, 4 * j:4 * j + 4] += sub
        out = np.zeros((16, 64), np.int64)
        for lane in range(32):
            for i in range(32):
                dr, col = _frag(lane, i)
                out[(lane >> 2) + dr, col] = acc[lane, i]
        np.testing.assert_array_equal(out, ref[w0:w0 + 16], err_msg=f"warp {w0}")


# -- the variant hooks in the one-pass order ------------------------------------


def _tree(v):
    """`tree_sum` of an f32 vector of a power-of-two length."""
    v = list(v)
    w = len(v) // 2
    while w >= 1:
        for k in range(w):
            v[k] = v[k] + v[k + w]
        w //= 2
    return v[0]


def _one_pass_core(qkv, n, s, heads, variant):
    """`variant_kernel<V, false>`'s softmax in its order, f32 numpy on the
    f32 scores (the product itself, f64 rounded once, stands in for the
    wgmma's): the max, p in place (E: exp2 of bf16 d, rounded to bf16),
    each quad lane's column pairs summed as trees chunk by chunk, the 4
    lanes of a row, P = p / l (A, C) or p rounded to qkv's dtype, P.V, then
    / l (B, D, E)."""
    assert s <= 272
    dt = qkv.dtype
    t = qkv.float().reshape(n, s, 3, heads, 64).permute(2, 0, 3, 1, 4)
    sc = (torch.matmul(t[0].double(), t[1].double().transpose(-1, -2)).float()
          * np.float32(sm.scale_of(variant))).numpy()
    m = sc.max(-1, keepdims=True)
    d = sc - m
    if variant == "E":
        p = torch.exp2(torch.from_numpy(d).to(torch.bfloat16).float()
                       ).to(torch.bfloat16).float().numpy()
    elif variant in "CD":
        p = np.exp2(d)
    else:
        p = np.exp(d)
    g = sm.variant_launch(s)
    chunks = [(64 * b, 64) for b in range(g.chunks64)] + [(64 * g.chunks64, 16)] * g.tail16
    lanes = np.zeros(p.shape[:-1] + (4,), np.float32)
    for k0, width in chunks:
        cols = np.zeros(p.shape[:-1] + (width,), np.float32)
        cols[..., :max(0, min(width, s - k0))] = p[..., k0:min(s, k0 + width)]
        for q in range(4):
            pairs = [cols[..., 8 * k + 2 * q] + cols[..., 8 * k + 2 * q + 1]
                     for k in range(width // 8)]
            lanes[..., q] += _tree(pairs)
    l = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]
    pt = torch.from_numpy(p / l if variant in "AC" else p).to(dt)
    o = torch.matmul(pt.double(), t[2].to(dt).double()).float()
    if variant not in "AC":
        o = o / torch.from_numpy(l)
    return sm.c.merge_heads(o.to(dt), n, s)


@pytest.mark.parametrize("variant", list(sm.VARIANTS))
@pytest.mark.parametrize("s", (17, 77, 201, 257))
def test_one_pass_hooks_match_core_ref_on_bf16(variant, s):
    """The kernel's order on bf16 qkv against the plain version within the
    card's limit (2 bf16 ulps of the plain output's largest magnitude)."""
    n, heads = 2, 2
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((n * s, 3 * 64 * heads))
                           .astype(np.float32)).to(torch.bfloat16)
    ours = _one_pass_core(qkv, n, s, heads, variant).float()
    ref = sm.core_ref(qkv, n, s, heads, variant).float()
    top = ref.abs().max().item()
    lim = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (ours - ref).abs().max().item() <= lim


N, S, E, H = 2, 17, 128, 2  # tests/test_torch_tools.py's small size


class _Exp2OfBf16:
    """jax.numpy with `exp2` of a bf16 operand taken as f32 exp2 of it,
    rounded to bf16 (variant E's exponential, as tests/test_torch_tools.py
    patches it); every other name is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        if x.dtype == jnp.bfloat16:
            return jnp.exp2(x.astype(jnp.float32)).astype(jnp.bfloat16)
        return jnp.exp2(x)


@pytest.fixture(scope="module")
def tool_outputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, S, E)).astype(np.float32)
    wqkv = (rng.standard_normal((E, 3 * E)) * 0.05).astype(np.float32)
    wproj = (rng.standard_normal((E, E)) * 0.05).astype(np.float32)
    ops = (jnp.asarray(wqkv), jnp.asarray(wproj))

    def call(kernel):
        spec = pl.BlockSpec((1, S, E), lambda n: (n, 0, 0))
        return np.asarray(pl.pallas_call(
            kernel, grid=(N,),
            in_specs=[spec] + [pl.BlockSpec(o.shape, lambda n: (0, 0)) for o in ops],
            out_specs=spec, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(jnp.asarray(x), *ops))

    outs = {v: call(jsm.make_kernel(v, H)) for v in "ABCD"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "jnp", _Exp2OfBf16())
        outs["E"] = call(jsm.make_kernel("E", H))
    return x, wqkv, wproj, outs


@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_one_pass_hooks_match_the_jax_tool(tool_outputs, variant, monkeypatch):
    """The tool's sub-layer with the kernel's order as its core, in f32,
    against the JAX tool's Pallas kernel (2e-5 of the largest value, the
    limit of tests/test_torch_tools.py)."""
    x, wqkv, wproj, outs = tool_outputs
    monkeypatch.setattr(sm, "attn_variant",
                        lambda qkv, n, s, h, v: _one_pass_core(qkv, n, s, h, v))
    out = sm.sublayer(torch.from_numpy(x), torch.from_numpy(wqkv),
                      torch.from_numpy(wproj), H, variant).numpy()
    ref = outs[variant]
    assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()
