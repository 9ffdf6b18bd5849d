"""`flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` on TMA + wgmma
(`mst_tpu_torch/csrc/flash_sm90.cuh`, `flash_fwd.cu`, `flash_bwd.cu`).

There is no card here, so the kernels do not run: these tests hold what
surrounds them. The launch geometry the card-side checks read
(`attention.flash_launch`) against the constants of the sources and the
shared memory of a block; the work units of the persistent grid covering
every query row and key once at the model lengths and head counts; the
sources holding wgmma, TMA and `setmaxnreg` and no mma.sync left; the
wrappers' refusals before any launch. `tests/test_torch_flash.py` holds the
plain versions to JAX; `chip_smoke.py` phases 2, 34 and 44 hold the same
geometry to the kernels' own export and the kernels to their plain
versions on the card."""

import re

import pytest
import torch

from mst_tpu_torch.ops import _build
from mst_tpu_torch.ops import attention as fa

SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block
H100_SMS = 132
LENGTHS = (1, 16, 63, 64, 65, 77, 513, 1029, 1370, 1601, 2048)
HEADS = (6, 12, 16, 24)  # ViT-S, ViT-B, ViT-L, giant2
SOURCES = ("flash_sm90.cuh", "flash_fwd.cu", "flash_bwd.cu")


def _constants(*names):
    """The `constexpr` ints of the sources in order (headers first), as the
    compiler would evaluate them (integer division, size_t as int)."""
    env = {}
    for name in names:
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for key, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
            expr = expr.replace("size_t(", "int(").replace("/", "//")
            env[key] = eval(expr, {"int": int}, dict(env))  # noqa: S307
    return env


def _text(name):
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


# -- geometry ----------------------------------------------------------------


def test_launch_geometry_mirrors_the_sources():
    c = _constants("gemm_sm90.cuh", "attn_sm90.cuh", "flash_sm90.cuh")
    assert (c["ROWS"], c["BOX"], c["STAGES"], c["THREADS"]) == (
        fa.FLASH_ROWS, fa.FLASH_BOX, fa.FLASH_STAGES, fa.FLASH_THREADS)
    assert c["THREADS"] == (1 + c["CONSUMERS"]) * 128
    assert c["ROWS"] == c["CONSUMERS"] * c["BOX"]
    assert c["VEC"] == 2 * c["BOX"] and c["BARS"] == 4 + 2 * c["STAGES"]
    assert c["HD"] == fa.HEAD_DIM and c["BOX_BYTES"] == 64 * 64 * 2
    # setmaxnreg moves the producer's registers to the consumers within the
    # allocation of one block an SM (65,536 registers)
    assert c["LAUNCH_REGS"] == 65_536 // c["THREADS"] // 8 * 8 == 168
    assert (c["PRODUCER_REGS"] * 128 + c["CONSUMER_REGS"] * 256
            == c["LAUNCH_REGS"] * c["THREADS"])
    assert c["PRODUCER_REGS"] % 8 == c["CONSUMER_REGS"] % 8 == 0
    head = _text("flash_sm90.cuh")
    assert "L.ring = L.unit + 2 * size_t(unit_boxes) * BOX_BYTES;" in head
    assert "L.vec = L.ring + size_t(STAGES) * 2 * BOX_BYTES;" in head
    assert ("L.bar = L.vec + (vec ? size_t(STAGES) * VEC * sizeof(float) : 0);"
            in head)
    assert "L.total = ALIGN + L.bar + BARS * sizeof(uint64_t);" in head
    assert "return Unit{u % T, bh % H, bh / H, size_t(bh)};" in head
    # the three entries' unit buffers: Q; Q and dO; K and V (+ vectors)
    assert "layout(2, false)" in _text("flash_fwd.cu")
    bwd = _text("flash_bwd.cu")
    assert "layout(4, false)" in bwd and "layout(4, true)" in bwd
    assert "geometry(B, H, S, part == 0 ? 2 : 4, part == 2, geo)" in \
        _text("flash_fwd.cu")


@pytest.mark.parametrize("part", fa.FLASH_PARTS)
def test_shared_memory_fits_one_block(part):
    g = fa.flash_launch(64, 6, 1370, part, H100_SMS)
    boxes = {"fwd": 2, "dq": 4, "dkv": 4}[part]
    st = fa.FLASH_STAGES
    assert g.smem == (1024 + 2 * boxes * 8192 + st * 2 * 8192
                      + (st * 128 * 4 if part == "dkv" else 0)
                      + (4 + 2 * st) * 8)
    assert g.smem <= SMEM_LIMIT
    # a box at a 1024-byte boundary: every region before the vectors and
    # barriers is a multiple of it
    assert (2 * boxes * 8192) % 1024 == 0 and (st * 2 * 8192) % 1024 == 0


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("s", LENGTHS)
def test_units_cover_every_row_and_key_once(s, heads):
    b = 3
    for part in fa.FLASH_PARTS:
        g = fa.flash_launch(b, heads, s, part, H100_SMS)
        assert g.tiles == -(-s // 128) and g.boxes == -(-s // 64)
        assert g.units == g.tiles * heads * b
        assert g.grid == min(g.units, H100_SMS) and g.threads == 384
        # the persistent grid: block i takes units i, i + grid, ...; each
        # unit once
        taken = sorted(u for blk in range(g.grid)
                       for u in range(blk, g.units, g.grid))
        assert taken == list(range(g.units))
        # each unit's rows: two consumer warpgroups of 64 rows; every row
        # of every (slice, head) in exactly one, and a warpgroup starts
        # below the tile's end
        owners = torch.zeros(b, heads, g.tiles * 128, dtype=torch.int32)
        for u in range(g.units):
            # `flash::unit`: the tile fastest, then the head, then the slice
            bh, tile = divmod(u, g.tiles)
            h, sl = bh % heads, bh // heads
            assert 0 <= tile < g.tiles and 0 <= h < heads and 0 <= sl < b
            for c in range(2):
                r0 = tile * 128 + c * 64
                owners[sl, h, r0:r0 + 64] += 1
        assert bool((owners[..., :s] == 1).all())
        # the streamed operand: boxes of 64 rows, every row in one, each
        # box starting below S
        keys = torch.zeros(g.boxes * 64, dtype=torch.int32)
        for j in range(g.boxes):
            assert j * 64 < s
            keys[j * 64:(j + 1) * 64] += 1
        assert bool((keys[:s] == 1).all())
        # the last box's ragged keys are masked (forward, dq) or are zero
        # rows with the LSE pad (dk/dv): never all of a box
        assert s - (g.boxes - 1) * 64 >= 1


def test_model_lengths_tiles():
    """The path lengths: 518 px ViT-S/14 (1370), 560 px (1601), DINOv3 at
    512 px (1029); their ragged last boxes leave 26, 1 and 5 keys."""
    for s, tiles, last in ((1370, 11, 26), (1601, 13, 1), (1029, 9, 5),
                           (77, 1, 13)):
        g = fa.flash_launch(1, 6, s, "fwd", H100_SMS)
        assert g.tiles == tiles and s - (g.boxes - 1) * 64 == last
    # the B=8 serving and B=2 step units share out evenly over 132 SMs
    assert fa.flash_launch(256, 6, 1370, "fwd", H100_SMS).units % 132 == 0
    assert fa.flash_launch(64, 6, 1370, "dq", H100_SMS).units % 132 == 0


# -- the sources -------------------------------------------------------------


def test_sources_hold_wgmma_and_tma_and_no_mma_sync():
    head = _text("flash_sm90.cuh")
    assert "cp.async.bulk.tensor.4d" in head
    assert "setmaxnreg.dec.sync.aligned.u32" in head
    assert "setmaxnreg.inc.sync.aligned.u32" in head
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in head
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        text = _text(name)
        assert '#include "flash_sm90.cuh"' in text
        assert "mma_16816" not in text and "cp_async16" not in text
        assert "ldsm" not in text and "mma.sync" not in text
        assert "attn::product_t" in text and "attn::mma_rs" in text
        assert "reg_dealloc<PRODUCER_REGS>" in text
        assert "reg_alloc<CONSUMER_REGS>" in text
        assert "__launch_bounds__(THREADS, 1)" in text
        assert "atomicAdd" not in text  # the same bits on every run
    # the forward's rounding points: P to bf16 in place as the A fragment
    # of P.V, the normalisation on the output, the base-2 LSE
    fwd = _text("flash_fwd.cu")
    assert "frag_a(p[kc], s, kc)" in fwd
    assert "m0 + log2f(fmaxf(l0, 1e-30f))" in fwd
    bwd = _text("flash_bwd.cu")
    assert "q < a.S ? lse[q] : LSE_PAD" in bwd
    assert "pack(ds, dp)" in bwd and "pack(pa, s)" in bwd


# -- refusals before any launch ----------------------------------------------


def _no_library():
    raise AssertionError("the kernel library was reached")


def _call(kind, q, k, v, sm_scale=None):
    b, h, s, _ = q.shape
    o = torch.zeros_like(q)
    vec = torch.zeros(b, h, s)
    if kind == "fwd":
        return fa.flash_fwd(q, k, v, sm_scale, want_lse=True)
    if kind == "dq":
        return fa.flash_bwd_dq(q, k, v, o, o, vec, sm_scale)
    return fa.flash_bwd_dkv(q, k, v, o, vec, vec, sm_scale)


def _operands(hd=64, dtype=torch.bfloat16, s=77):
    qkv = torch.zeros(2, s, 3, 6, hd, dtype=dtype)
    return tuple(u.transpose(1, 2) for u in qkv.unbind(2))


REFUSED = {
    "head dim 32": (lambda: _operands(hd=32), None, ValueError, "head dim 64"),
    "head dim 128": (lambda: _operands(hd=128), None, ValueError,
                     "head dim 64"),
    "f16": (lambda: _operands(dtype=torch.float16), None, TypeError,
            "bfloat16"),
    "f32": (lambda: _operands(dtype=torch.float32), None, TypeError,
            "bfloat16"),
    "row stride 4": (lambda: tuple(
        torch.zeros(2, 6, 77, 68, dtype=torch.bfloat16)[..., :64]
        .as_strided((2, 6, 77, 64), (6 * 77 * 68, 77 * 68, 68, 1))
        for _ in range(3)), None, ValueError, "multiples of 8"),
    "column stride 2": (lambda: tuple(
        torch.zeros(2, 6, 77, 128, dtype=torch.bfloat16)[..., ::2]
        for _ in range(3)), None, ValueError, "unit last stride"),
    "sm_scale 0": (_operands, 0.0, ValueError, "sm_scale > 0"),
    "sm_scale < 0": (_operands, -0.125, ValueError, "sm_scale > 0"),
}


@pytest.mark.parametrize("case", list(REFUSED))
@pytest.mark.parametrize("kind", fa.FLASH_PARTS)
def test_wrappers_refuse_before_any_launch(monkeypatch, kind, case):
    make, sm_scale, exc, what = REFUSED[case]
    monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", _no_library)
    q, k, v = make()
    with pytest.raises(exc, match=what):
        _call(kind, q, k, v, sm_scale)


@pytest.mark.parametrize("s", (1, 77, 1029, 1370))
@pytest.mark.parametrize("kind", fa.FLASH_PARTS)
def test_wrappers_accept_kernel_operands(monkeypatch, kind, s):
    """Head views of a packed qkv, and contiguous (RoPE'd) q, k beside a
    viewed v (DINOv3), pass the checks and reach the library (here a
    stand-in that stops the call)."""
    class Reached(Exception):
        pass

    def stand_in():
        raise Reached

    monkeypatch.setattr(fa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "lib", stand_in)
    q, k, v = _operands(s=s)
    for ops in ((q, k, v), (q.contiguous(), k.contiguous(), v)):
        with pytest.raises(Reached):
            _call(kind, *ops)
