"""Flash attention on hand-written Hopper kernels, and the device dispatch
shared by the port's ops.

Counterpart of `mst_tpu/ops/attention.py`: the attention of the composed
ViT blocks (`models/layers.Attention`), which runs wherever the fused
sub-layers are gated off (S = 1 + registers + patches above
`vit_fast.FUSED_MAX_TOKENS`, e.g. 1370 tokens for 518 px ViT-S/14 slices).

- `flash_attention(q, k, v, sm_scale=None)`: q, k, v [B, H, S, hd] (any
  strides with a unit last one, such as the head views of a packed qkv)
  -> o [B, H, S, hd], laid out as [B, S, H, hd] so that the output
  projection reads it as [B, S, H * hd] without a copy. With grad enabled
  it is a `torch.autograd.Function` whose forward also keeps the base-2
  log-sum-exp rows and whose backward runs the two backward kernels.
- `flash_fwd` (rows 12 and 13 of ROADMAP queue B: `_fwd_single_kernel`
  :152 and `_fwd_kernel` :96; csrc/flash_fwd.cu), `flash_bwd_dq` (row 15,
  `_bwd_dq_kernel` :340, and the dq of row 14, `_bwd_single_kernel` :305)
  and `flash_bwd_dkv` (row 16, `_bwd_dkv_kernel` :372, and the dk, dv of
  row 14; csrc/flash_bwd.cu): the kernel wrappers. The whole-sequence /
  blocked split of the Pallas kernels at `SINGLE_BLOCK_MAX_KV` = 1536 and
  their `_pad_to` copies are VMEM artifacts: one online-softmax kernel per
  direction covers every S, the ragged edge read as zeros by TMA and
  masked. Each kernel is a persistent grid of one block an SM: a producer
  warpgroup streams 64-row TMA boxes through an 8-stage ring into two
  wgmma consumer warpgroups of 64 rows of a 128-row unit
  (csrc/flash_sm90.cuh); `flash_launch` mirrors its geometry.
- `attention_reference` and `_flash_bwd_dq_ref` / `_flash_bwd_dkv_ref`:
  their plain versions, which round where the kernels round (P to the
  working dtype before P.V, the normalisation on the [S, hd] output, ds
  before dq and dk) and keep f64 when given f64 (the oracle).

A CUDA tensor launches the kernel (bf16, head dim 64: every ViT size,
sm_scale > 0) and counts the launch; a CPU tensor takes the plain version.
There is no third path, and no fallback from one to the other.

The serving kernels are also registered ops, `torch.ops.mst_tpu_torch.*`
(`flash_fwd` here, the fused sub-layers' in `fused_block.py` and
`fused_int8.py`): the CUDA implementation of each is its ctypes launch,
the CPU one its plain version, and a fake one gives the output's shape,
dtype and strides. The wrappers call their ops while `torch.export`
traces a program (`mst_tpu_torch/export.py`, which records the ops in the
graph) and only then; otherwise they launch directly, or on the CPU run
the plain version, which keeps its autograd (the ops have no backward).

The LSE is base 2 in the scaled units of the softmax (`m + log2(l)` of
s = q.k * sm_scale * log2(e)), as `mhsa` keeps it; JAX's natural-log rows
are this / log2(e), and only the port's own kernels read them: the
backward, and the saliency outputs above 512 tokens.

Saliency above 512 tokens (JAX serves it on its flax path, whose
`attention_reference` sows every block's per-head [N, H, S, S]
probabilities) rides the same forward: `flash_attention_saliency` runs
`flash_fwd` with its LSE, then one of `flash_row` (the CLS row of the last
block), `flash_carry` (the rollout carry moved one block on) and
`flash_abnar` (the row normaliser of the block's Abnar factor),
hand-written kernels that rebuild p = exp2(s - lse) tile by tile from the
same q and k (csrc/flash_sal.cu, TMA + wgmma; `flash_sal_launch` mirrors
their geometry). The Abnar rollout reads only the CLS row of the factors'
product, so `abnar_rollout_row` carries that row back from the newest
block to the oldest with one `flash_carry` a block, on the q, k, LSE and
row normaliser each block kept: no factor and no [S, S] product is made.
No TPU kernel computes these: they replace XLA's reductions of the sown
probabilities. Their plain versions (`_flash_row_ref`, `_flash_carry_ref`,
`_flash_abnar_ref`) rebuild the probabilities a head at a time.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from mst_tpu_torch.ops import _build

# Finite "minus infinity" for masked scores: a fully masked row stays free
# of NaN (mst_tpu/ops/attention.py NEG_INF).
NEG_INF = -1e30
LOG2E = math.log2(math.e)
HEAD_DIM = 64  # the kernels' head dim: E / heads of every ViT size


def _on_cuda(x: torch.Tensor) -> bool:
    """True when `x` must go through a CUDA kernel, False when it takes the
    plain PyTorch version (CPU). Any other device raises: there is no third
    path."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"mst_tpu_torch kernels run on CUDA or CPU tensors, got {x.device}")


def exporting() -> bool:
    """True while `torch.export` traces: the serving kernel wrappers then
    call their registered ops, which the graph records, and no launch or
    sub-layer call is counted."""
    return torch.compiler.is_exporting()


def _f(t):
    """t in f32, or as it is if it is f64 (the plain path in f64 keeps its
    precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _mm(a, b):
    """Working-dtype operands, f32 (or f64) product."""
    return torch.matmul(_f(a), _f(b))


def _scale(q, sm_scale):
    if sm_scale is None:
        return 1.0 / math.sqrt(q.shape[-1])
    return float(sm_scale)


def _like_out(q):
    """An empty [B, H, S, hd] tensor laid out as [B, S, H, hd]."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


# ---------------------------------------------------------------------------
# Plain versions (CPU path; what the kernels are held to on the card)
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, sm_scale=None, want_lse: bool = False):
    """Softmax attention over [B, H, S, hd] -> o (and with `want_lse` the
    base-2 LSE [B, H, S] f32): s = q.k^T * sm_scale * log2(e) with f32
    sums, p = exp2(s - rowmax), l = rowsum(p), o = (bf16(p).v) / l in the
    working dtype, as the flash kernels and the Pallas bodies compute it."""
    scale = _scale(q, sm_scale) * LOG2E
    s = _mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = (_mm(p.to(v.dtype), v) * torch.where(l > 0, 1.0 / l, 0.0)).to(q.dtype)
    if not want_lse:
        return o
    return o, (m + torch.log2(l.clamp_min(1e-30)))[..., 0]


def _probs(q, k, lse, sm_scale):
    """p = exp2(s - lse) rebuilt from the saved base-2 LSE rows."""
    s = _mm(q, k.transpose(-1, -2)) * (sm_scale * LOG2E)
    return torch.exp2(s - _f(lse)[..., None])


def _head_probs(q, k, lse, h, sm_scale):
    """p of head h, [B, S_q, S] (one head at a time: at 518 px and B=8 a
    head's p is 1.92 GB in f32, all six 11.5 GB)."""
    return _probs(q[:, h], k[:, h], lse[:, h], sm_scale)


def _flash_row_ref(q, k, lse, sm_scale=None):
    """The CLS row p[0] of each head, [B, H, S] f32 (`_mhsa_ref`'s
    `want_row` form: p[0] / l, here exp2(s - lse) of the saved LSE)."""
    sm = _scale(q, sm_scale)
    return torch.stack([_head_probs(q[:, :, :1], k, lse[:, :, :1], h, sm)[:, 0]
                        for h in range(q.shape[1])], 1)


def _flash_carry_ref(q, k, lse, carry, sm_scale=None):
    """The rollout carry moved one block on, sum_q carry[q] p[q, k] per
    head, [B, H, S] f32 (`_mhsa_ref`'s `carry` form)."""
    sm = _scale(q, sm_scale)
    return torch.stack([(_f(carry[:, h, :, None]) *
                         _head_probs(q, k, lse, h, sm)).sum(-2)
                        for h in range(q.shape[1])], 1)


def _flash_abnar_ref(q, k, lse, sm_scale=None):
    """The row normaliser of the Abnar & Zuidema factor rownorm(mean_h p +
    I), rs [B, S] f32 (f64 on f64 inputs): 1 + (1 / H) sum_h sum_k p_h[q,
    k], the row sums first, then the heads summed in order."""
    sm, heads = _scale(q, sm_scale), q.shape[1]
    hs = _head_probs(q, k, lse, 0, sm).sum(-1)
    for h in range(1, heads):
        hs = hs + _head_probs(q, k, lse, h, sm).sum(-1)
    return hs * (1.0 / heads) + 1.0


def _delta(o, do):
    """delta = rowsum(do * o) in f32 [B, H, S] (JAX `_flash_bwd`'s XLA
    reduction)."""
    return (_f(do) * _f(o)).sum(-1)


def _flash_bwd_dq_ref(q, k, v, o, do, lse, sm_scale):
    """-> (dq, delta): dq = bf16(ds) k with ds = p * (do.v^T - delta) *
    sm_scale, as `_bwd_dq_kernel`."""
    p = _probs(q, k, lse, sm_scale)
    delta = _delta(o, do)
    ds = (p * (_mm(do, v.transpose(-1, -2)) - delta[..., None])
          * sm_scale).to(q.dtype)
    return _mm(ds, k).to(q.dtype), delta


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, sm_scale):
    """-> (dk, dv): dv = bf16(p)^T do, dk = bf16(ds)^T q, as
    `_bwd_dkv_kernel`."""
    p = _probs(q, k, lse, sm_scale)
    dv = _mm(p.to(q.dtype).transpose(-1, -2), do).to(q.dtype)
    ds = (p * (_mm(do, v.transpose(-1, -2)) - _f(delta)[..., None])
          * sm_scale).to(q.dtype)
    return _mm(ds.transpose(-1, -2), q).to(q.dtype), dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _view(t, name, shape, like):
    """Check a [B, H, S, 64] bf16 operand of the flash kernels: on `like`'s
    device, a unit last stride, 16-byte rows (the kernels copy 8 values at
    a time). Returns its (batch, head, row) strides."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    st = t.stride()
    if st[3] != 1 or any(x % 8 for x in st[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride, the others "
                         f"multiples of 8 and a 16-byte aligned start; got "
                         f"strides {st}")
    return st[:3]


def _shape(q, sm_scale):
    b, h, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the flash kernels take head dim {HEAD_DIM}, got "
                         f"{d}")
    if b * h * (-(-s // FLASH_ROWS)) >= 2**31 or b * h * s >= 2**31:
        raise ValueError(f"flash attention grid too large: {tuple(q.shape)}")
    if not 0.0 < sm_scale < math.inf:
        raise ValueError(f"the flash kernels take a finite sm_scale > 0 "
                         f"(the row max is taken before the scale); got "
                         f"{sm_scale}")
    return b, h, s


# The launch geometry of the three kernels (csrc/flash_sm90.cuh): units of
# FLASH_ROWS rows of one (slice, head), FLASH_BOX-row TMA boxes, a ring of
# FLASH_STAGES stages, FLASH_THREADS threads (a producer warpgroup and two
# consumers) and one block an SM.
FLASH_ROWS, FLASH_BOX, FLASH_STAGES, FLASH_THREADS = 128, 64, 8, 384
_FLASH_BOX_BYTES = FLASH_BOX * HEAD_DIM * 2
FLASH_PARTS = ("fwd", "dq", "dkv")


def flash_launch(b: int, h: int, s: int, part: str,
                 sms: int) -> SimpleNamespace:
    """The launch geometry of `flash_fwd` ("fwd"), `flash_bwd_dq` ("dq") or
    `flash_bwd_dkv` ("dkv") over [b, h, s, 64] on a card of `sms` SMs, as
    `mst_flash_geometry` exports it: rows of a unit and of a box, query (or
    key) tiles, boxes, units (tile fastest, then head, then slice), the
    persistent grid, threads, stages and dynamic shared memory (1 KB of
    alignment; two unit buffers of 2 boxes (Q) or 4 (Q, dO; K, V); the ring
    of two boxes a stage; for dk/dv the stages' f32 LSE and delta rows; 12
    barriers)."""
    if part not in FLASH_PARTS or min(b, h, s) < 1:
        raise ValueError(f"flash_launch({b}, {h}, {s}, {part!r})")
    tiles = -(-s // FLASH_ROWS)
    units = tiles * h * b
    unit_boxes = 2 if part == "fwd" else 4
    smem = (1024 + 2 * unit_boxes * _FLASH_BOX_BYTES
            + FLASH_STAGES * 2 * _FLASH_BOX_BYTES
            + (FLASH_STAGES * 2 * FLASH_BOX * 4 if part == "dkv" else 0)
            + (4 + 2 * FLASH_STAGES) * 8)
    return SimpleNamespace(rows=FLASH_ROWS, box=FLASH_BOX, tiles=tiles,
                           boxes=-(-s // FLASH_BOX), units=units,
                           grid=min(units, sms), threads=FLASH_THREADS,
                           stages=FLASH_STAGES, smem=smem)


def _lse(t, name, b, h, s, like):
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s)
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"{name} must be contiguous f32 {(b, h, s)} on "
                         f"{like.device}")
    return t


def _strides(*triples):
    flat = [int(x) for tr in triples for x in tr]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, sm_scale=None, want_lse: bool = False):
    """o [B, H, S, hd] (laid out [B, S, H, hd]) of softmax attention; with
    `want_lse` also the base-2 LSE [B, H, S] f32. The serving form is the
    registered op `mst_tpu_torch::flash_fwd`, the LSE form (which the
    saliency forward serves on) `mst_tpu_torch::flash_fwd_lse`."""
    if exporting():
        op = _flash_fwd_lse_op if want_lse else _flash_fwd_op
        return op(q, k, v, _scale(q, sm_scale))
    if not _on_cuda(q):
        return attention_reference(q, k, v, sm_scale, want_lse)
    return _flash_fwd_cuda(q, k, v, sm_scale, want_lse)


def _flash_fwd_cuda(q, k, v, sm_scale, want_lse: bool):
    """The launch of `mst_flash_fwd` (counted) on checked operands."""
    b, h, s = _shape(q, _scale(q, sm_scale))
    strides = [_view(t, n, q.shape, q) for t, n in ((q, "q"), (k, "k"),
                                                    (v, "v"))]
    o = _like_out(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if want_lse else None)
    err = _build.lib().mst_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _strides(*strides, o.stride()[:3]), b, h, s,
        _scale(q, sm_scale) * LOG2E, _stream(q))
    _build.check(err, "mst_flash_fwd")
    flash_fwd.launches += 1
    return (o, lse) if want_lse else o


@torch.library.custom_op("mst_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float) -> torch.Tensor:
    return _flash_fwd_cuda(q, k, v, sm_scale, False)


@_flash_fwd_op.register_kernel("cpu")
def _(q, k, v, sm_scale):
    # the kernel's layout, so that the graph's strides hold on either device
    return _like_out(q).copy_(attention_reference(q, k, v, sm_scale))


@_flash_fwd_op.register_fake
def _(q, k, v, sm_scale):
    return _like_out(q)


@torch.library.custom_op("mst_tpu_torch::flash_fwd_lse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return _flash_fwd_cuda(q, k, v, sm_scale, True)


@_flash_fwd_lse_op.register_kernel("cpu")
def _(q, k, v, sm_scale):
    o, lse = attention_reference(q, k, v, sm_scale, want_lse=True)
    return _like_out(q).copy_(o), lse.contiguous()


@_flash_fwd_lse_op.register_fake
def _(q, k, v, sm_scale):
    return _like_out(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def flash_bwd_dq(q, k, v, o, do, lse, sm_scale=None):
    """-> (dq [B, H, S, hd] laid out as o, delta [B, H, S] f32): the dq
    kernel, which also writes delta = rowsum(do * o) for `flash_bwd_dkv`."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return _flash_bwd_dq_ref(q, k, v, o, do, lse, sm_scale)
    b, h, s = _shape(q, sm_scale)
    strides = [_view(t, n, q.shape, q) for t, n in (
        (q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"))]
    _lse(lse, "lse", b, h, s, q)
    dq = _like_out(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.lib().mst_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(*strides, dq.stride()[:3]), b, h, s, sm_scale * LOG2E,
        sm_scale, _stream(q))
    _build.check(err, "mst_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, sm_scale=None):
    """-> (dk, dv), [B, H, S, hd] each, laid out as o."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, sm_scale)
    b, h, s = _shape(q, sm_scale)
    strides = [_view(t, n, q.shape, q) for t, n in (
        (q, "q"), (k, "k"), (v, "v"), (do, "do"))]
    _lse(lse, "lse", b, h, s, q)
    _lse(delta, "delta", b, h, s, q)
    dk, dv = _like_out(q), _like_out(q)
    err = _build.lib().mst_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(*strides, dk.stride()[:3], dv.stride()[:3]), b, h, s,
        sm_scale * LOG2E, sm_scale, _stream(q))
    _build.check(err, "mst_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


# The launch geometry of the saliency kernels (csrc/flash_sal.cu): the
# persistent producer / consumer blocks of the flash kernels (FLASH_ROWS-row
# units, FLASH_BOX-row TMA boxes, FLASH_THREADS threads, one block an SM)
# with a ring of SAL_STAGES stages. The CLS row and the carry take a key
# tile of one (slice, head), the queries streaming through the ring
# SAL_CARRY_ROWS a stage with their f32 LSE and weights (the CLS row the
# first stage alone); the row normaliser a query tile of one slice, the keys
# of every head in turn, SAL_ABNAR_ROWS a stage.
SAL_CARRY_ROWS, SAL_ABNAR_ROWS, SAL_STAGES = 64, 128, 8
SAL_PARTS = ("row", "carry", "abnar")
SAL_GEOMETRY = ("rows", "box", "tiles", "units", "grid", "threads", "stages",
                "smem", "walks")


def flash_sal_launch(b: int, h: int, s: int, part: str,
                     sms: int) -> SimpleNamespace:
    """The launch geometry of `flash_row` ("row"), `flash_carry` ("carry")
    or `flash_abnar` ("abnar") over [b, h, s, 64] on a card of `sms` SMs,
    as `mst_flash_sal_geometry` exports it: rows of a unit and of a box,
    tiles, units (row / carry: key tile fastest, then head, then slice;
    abnar: query tile, then slice), the persistent grid, threads, ring
    stages, dynamic shared memory (1 KB of alignment, two unit buffers of
    two boxes, the ring; row / carry: the stages' f32 LSE and weight rows;
    the barriers) and the ring stages a unit streams."""
    if part not in SAL_PARTS or min(b, h, s) < 1:
        raise ValueError(f"flash_sal_launch({b}, {h}, {s}, {part!r})")
    carry = part != "abnar"
    rows = SAL_CARRY_ROWS if carry else SAL_ABNAR_ROWS
    tiles, stages = -(-s // FLASH_ROWS), -(-s // rows)
    units = tiles * b * (h if carry else 1)
    smem = (1024 + 4 * _FLASH_BOX_BYTES + SAL_STAGES * rows * HEAD_DIM * 2
            + (SAL_STAGES * 2 * rows * 4 if carry else 0)
            + (4 + 2 * SAL_STAGES) * 8)
    walks = {"row": 1, "carry": stages, "abnar": h * stages}[part]
    return SimpleNamespace(rows=FLASH_ROWS, box=FLASH_BOX, tiles=tiles,
                           units=units, grid=min(units, sms),
                           threads=FLASH_THREADS, stages=SAL_STAGES,
                           smem=smem, walks=walks)


def _flash_sal_cuda(part, q, k, lse, carry, sm_scale):
    """The launch of `mst_flash_carry` (the row and carry forms) or
    `mst_flash_abnar` on checked operands, counted under its wrapper."""
    b, h, s = _shape(q, sm_scale)
    strides = [_view(t, n, q.shape, q) for t, n in ((q, "q"), (k, "k"))]
    _lse(lse, "lse", b, h, s, q)
    if part == "carry":
        _lse(carry, "carry", b, h, s, q)
    lib, scale = _build.lib(), sm_scale * LOG2E
    if part == "abnar":
        out = torch.empty((b, s), dtype=torch.float32, device=q.device)
        err = lib.mst_flash_abnar(q.data_ptr(), k.data_ptr(), lse.data_ptr(),
                                  out.data_ptr(), _strides(*strides), b, h, s,
                                  scale, _stream(q))
        _build.check(err, "mst_flash_abnar")
        flash_abnar.launches += 1
        return out
    out = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = lib.mst_flash_carry(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(),
        None if carry is None else carry.data_ptr(), out.data_ptr(),
        _strides(*strides), b, h, s, scale, int(part == "row"), _stream(q))
    _build.check(err, "mst_flash_carry")
    (flash_row if part == "row" else flash_carry).launches += 1
    return out


def flash_row(q, k, lse, sm_scale=None):
    """The CLS row of each head's softmax, p[0] [B, H, S] f32, from q, k
    [B, H, S, hd] and the base-2 LSE rows of `flash_fwd(want_lse=True)`: the
    ROW form of the carry kernel (the first query tile alone)."""
    if exporting():
        return _flash_row_op(q, k, lse, _scale(q, sm_scale))
    if not _on_cuda(q):
        return _flash_row_ref(q, k, lse, sm_scale)
    return _flash_sal_cuda("row", q, k, lse, None, _scale(q, sm_scale))


def flash_carry(q, k, lse, carry, sm_scale=None):
    """The rollout carry [B, H, S] f32 moved through this attention,
    new[k] = sum_q carry[q] p[q, k] per head."""
    if exporting():
        return _flash_carry_op(q, k, lse, carry, _scale(q, sm_scale))
    if not _on_cuda(q):
        return _flash_carry_ref(q, k, lse, carry, sm_scale)
    return _flash_sal_cuda("carry", q, k, lse, carry, _scale(q, sm_scale))


def flash_abnar(q, k, lse, sm_scale=None):
    """The row normaliser of this attention's Abnar & Zuidema factor
    rownorm(mean_h p + I): rs [B, S] f32, 1 + (1 / H) sum_h sum_k p_h[q, k]
    (the factor itself is never made: `abnar_rollout_row`)."""
    if exporting():
        return _flash_abnar_op(q, k, lse, _scale(q, sm_scale))
    if not _on_cuda(q):
        return _flash_abnar_ref(q, k, lse, sm_scale)
    return _flash_sal_cuda("abnar", q, k, lse, None, _scale(q, sm_scale))


def _sal_rows(q):
    return q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("mst_tpu_torch::flash_row", mutates_args=(),
                         device_types="cuda")
def _flash_row_op(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                  sm_scale: float) -> torch.Tensor:
    return _flash_sal_cuda("row", q, k, lse, None, sm_scale)


_flash_row_op.register_kernel("cpu")(
    lambda q, k, lse, sm_scale: _flash_row_ref(q, k, lse, sm_scale)
    .contiguous())
_flash_row_op.register_fake(lambda q, k, lse, sm_scale: _sal_rows(q))


@torch.library.custom_op("mst_tpu_torch::flash_carry", mutates_args=(),
                         device_types="cuda")
def _flash_carry_op(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                    carry: torch.Tensor, sm_scale: float) -> torch.Tensor:
    return _flash_sal_cuda("carry", q, k, lse, carry, sm_scale)


_flash_carry_op.register_kernel("cpu")(
    lambda q, k, lse, carry, sm_scale: _flash_carry_ref(
        q, k, lse, carry, sm_scale).contiguous())
_flash_carry_op.register_fake(
    lambda q, k, lse, carry, sm_scale: _sal_rows(q))


@torch.library.custom_op("mst_tpu_torch::flash_abnar", mutates_args=(),
                         device_types="cuda")
def _flash_abnar_op(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    return _flash_sal_cuda("abnar", q, k, lse, None, sm_scale)


_flash_abnar_op.register_kernel("cpu")(
    lambda q, k, lse, sm_scale: _flash_abnar_ref(q, k, lse, sm_scale)
    .contiguous())
_flash_abnar_op.register_fake(
    lambda q, k, lse, sm_scale: q.new_empty((q.shape[0], q.shape[2]),
                                            dtype=torch.float32))


# The kernels a saliency forward composes (`flash_attention_saliency`,
# `abnar_rollout_row`): the wrappers, or (chip_smoke.py) the plain versions
# on the card.
SAL_KERNELS = SimpleNamespace(fwd=flash_fwd, row=flash_row, carry=flash_carry,
                              abnar=flash_abnar)


def flash_attention_saliency(q, k, v, want_row: bool = False, carry=None,
                             abnar: bool = False, sm_scale=None,
                             ops=SAL_KERNELS):
    """Serving attention with one saliency output, as `mhsa`'s flags give
    it on the fused path: -> (o, CLS row [B, H, S] | the carry moved on
    [B, H, S] | the block's Abnar state (q, k, lse, rs)). `flash_fwd` keeps
    its LSE rows, and the output's kernel rebuilds p from them and from the
    same q, k (after RoPE): no [S, S] matrix of a head is ever held. The
    Abnar state is what `abnar_rollout_row` needs of the block: q and k
    (copies where they are views of the packed qkv, so that neither it nor
    v stays alive), the LSE and the row normaliser rs [B, S] f32."""
    if sum((want_row, carry is not None, abnar)) != 1:
        raise ValueError("flash_attention_saliency takes one of want_row, "
                         "carry and abnar")
    sm_scale = _scale(q, sm_scale)
    o, lse = ops.fwd(q, k, v, sm_scale, want_lse=True)
    if carry is not None:
        return o, ops.carry(q, k, lse, carry, sm_scale)
    if abnar:
        q, k = q.contiguous(), k.contiguous()
        return o, (q, k, lse, ops.abnar(q, k, lse, sm_scale))
    return o, ops.row(q, k, lse, sm_scale)


def abnar_rollout_row(blocks, ops=SAL_KERNELS):
    """The CLS row of A_{L-1} ... A_0, the Abnar & Zuidema rollout's product
    of the blocks' factors A_l = rownorm(mean_h p_l,h + I) (JAX's
    `attention_rollout`), from each block's state (q, k, lse, rs) of
    `flash_attention_saliency(abnar=True)` at the default sm_scale, oldest
    first -> [B, S] f32. The row moves back through the blocks, newest
    first: from v = e_0 (one-hot at CLS), w = v / rs_l and v = mean_h
    carry_h(w) + w, where carry_h is `flash_carry` with w for every head;
    only that row is ever read, so no factor and no [S, S] product is
    made."""
    v = torch.zeros_like(blocks[-1][3])
    v[:, 0] = 1.0
    for q, k, lse, rs in reversed(blocks):
        w = v / rs
        moved = ops.carry(q, k, lse,
                          w[:, None].expand(q.shape[:3]).contiguous())
        v = moved.mean(1) + w
    return v


# The forward and backward a `flash_attention` call composes: the kernel
# wrappers (plain versions on the CPU). `chip_smoke.py` passes the plain
# versions instead, to run the plain composed path on the card.
KERNELS = SimpleNamespace(fwd=flash_fwd, bwd_dq=flash_bwd_dq,
                          bwd_dkv=flash_bwd_dkv)


class _FlashAttention(torch.autograd.Function):
    """JAX's `_flash_attention` custom VJP: the forward keeps (q, k, v, o,
    LSE), the backward runs dq (with delta) then dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, ops):
        o, lse = ops.fwd(q, k, v, sm_scale, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.ops = sm_scale, ops
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        ops, sm_scale = ctx.ops, ctx.sm_scale
        do = g.to(q.dtype)
        st = do.stride()
        if st[3] != 1 or any(x % 8 for x in st[:3]) or do.data_ptr() % 16:
            do = do.contiguous()  # e.g. the expanded grad of a sum
        dq, delta = ops.bwd_dq(q, k, v, o, do, lse, sm_scale)
        dk, dv = ops.bwd_dkv(q, k, v, do, lse, delta, sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, sm_scale=None, ops=KERNELS):
    """Softmax attention over q, k, v [B, H, S, hd] -> [B, H, S, hd]
    (`mst_tpu.ops.attention.flash_attention`, full attention without a
    mask). Without grad it runs the forward alone, with no LSE output."""
    sm_scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, sm_scale, ops)
    return ops.fwd(q, k, v, sm_scale)


# `.launches` of each wrapper counts its kernel's launches; the registry of
# `ops/fused_block.py` (`launch_counts`, `reset_launch_counts`) holds these
# three with the other kernels. None moves on the CPU path.
flash_fwd.launches = flash_bwd_dq.launches = flash_bwd_dkv.launches = 0
flash_row.launches = flash_carry.launches = flash_abnar.launches = 0
