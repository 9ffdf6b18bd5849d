"""The port's `tools/` experiments (`mst_tpu_torch.tools`, queue B rows
17-21) on CPU tensors against the JAX tools' Pallas kernels, built with
`pl.pallas_call(..., interpret=True)` at a small size, in f32 on the same
numpy inputs:

- row 18: each softmax variant A-E of `tools/bench_attn_softmax.py`'s
  `make_kernel` (the whole sub-layer: qkv, attention, proj, residual);
- row 21: `_mhsa_base` and `_mhsa_split` of `tools/bench_attn_split_cls.py`;
- row 19: variants A-C of `tools/bench_attn_i8.py`'s static W8A8 kernel;
- row 20: `tools/debug_attn_i8.py`'s `xla_ref` against the port's mirror;
- row 17: the split (two programs) and block (one program) forms of
  `tools/bench_block_fusion.py`.

On the CPU every kernel wrapper takes its plain version, so these pin the
plain versions the CUDA kernels are held to on the card (`chip_smoke.py`
phases 38-39). Limits: 2e-5 of the largest value (bf16 experiments run in
f32 here); the int8 ones 1e-4, since a code may flip where the two
frameworks' f32 LN lands on the other side of a .5 tie. The JAX tools'
module globals are patched for the small size (`monkeypatch`; no file
changes), and each Pallas call runs once per module."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.bench_attn_i8 as jbi
import tools.bench_attn_softmax as jsm
import tools.bench_attn_split_cls as jsc
import tools.bench_block_fusion as jbf
import tools.debug_attn_i8 as jdbg
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.tools import bench_attn_i8 as bi
from mst_tpu_torch.tools import bench_attn_softmax as sm
from mst_tpu_torch.tools import bench_attn_split_cls as sc
from mst_tpu_torch.tools import bench_block_fusion as bf
from mst_tpu_torch.tools import debug_attn_i8 as dbg
from mst_tpu_torch.tools import loss_drift as ld
from mst_tpu_torch.tools import saliency_spread as ss

N, S, E, H = 2, 17, 128, 2  # head dim 64, as every kernel of the port
REL, REL_I8 = 2e-5, 1e-4
# JAX lowers `jnp.exp2` of a bf16 operand to exp(bf16(bf16(ln 2) * d)) in
# bf16, one rounding of the exponent's argument more than variant E's f32
# exp2 of the bf16 d (which the card's h2exp2 approximates): the tool's
# unpatched E lies 1.6e-4 of the largest value from the port's here.
REL_E_JAX = 1e-3


class _Exp2OfBf16:
    """jax.numpy with `exp2` of a bf16 operand taken as f32 exp2 of it,
    rounded to bf16 (variant E's exponential, ROADMAP "Known
    differences"); every other name is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        if x.dtype == jnp.bfloat16:
            return jnp.exp2(x.astype(jnp.float32)).astype(jnp.bfloat16)
        return jnp.exp2(x)


def _close(ours, ref, rel, what=""):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _full(shape):
    return pl.BlockSpec(shape, lambda n: (0,) * len(shape))


def _per_slice(s, e):
    return pl.BlockSpec((1, s, e), lambda n: (n, 0, 0))


def _call(kernel, x, operands):
    """`kernel` over a grid of slices: x [N, S, E] one slice a step, every
    operand whole (the tools' BlockSpecs, in interpret mode)."""
    n, s, e = x.shape
    return pl.pallas_call(
        kernel, grid=(n,),
        in_specs=[_per_slice(s, e)] + [_full(o.shape) for o in operands],
        out_specs=_per_slice(s, e),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x, *operands)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    tfb.reset_launch_counts()
    yield
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch


# -- row 18: softmax forms ---------------------------------------------------


@pytest.fixture(scope="module")
def softmax_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, S, E)).astype(np.float32)
    wqkv = (rng.standard_normal((E, 3 * E)) * 0.05).astype(np.float32)
    wproj = (rng.standard_normal((E, E)) * 0.05).astype(np.float32)
    ops = (jnp.asarray(wqkv), jnp.asarray(wproj))
    outs = {v: np.asarray(_call(jsm.make_kernel(v, H), jnp.asarray(x), ops))
            for v in sm.VARIANTS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "jnp", _Exp2OfBf16())
        outs["E, f32 exp2"] = np.asarray(_call(jsm.make_kernel("E", H),
                                               jnp.asarray(x), ops))
    return x, wqkv, wproj, outs


@pytest.mark.parametrize("variant", list(sm.VARIANTS))
def test_softmax_variant_matches_tool_kernel(softmax_case, variant):
    x, wqkv, wproj, outs = softmax_case
    out = sm.sublayer(_t(x), _t(wqkv), _t(wproj), H, variant)
    if variant == "E":
        _close(out.numpy(), outs["E, f32 exp2"], REL, "E, f32 exp2")
        _close(out.numpy(), outs["E"], REL_E_JAX, "E, JAX's bf16 exp2")
    else:
        _close(out.numpy(), outs[variant], REL, variant)
    # the chain is the sub-layer applied DEPTH times
    two = sm.chain(_t(x), _t(wqkv), _t(wproj), H, variant, depth=2)
    _close(two.numpy(),
           sm.sublayer(out, _t(wqkv), _t(wproj), H, variant).numpy(), 0.0)


def test_softmax_d_is_mhsa_and_e_takes_bf16_probabilities(softmax_case):
    """D is `mhsa`'s math bit for bit; E's P is bf16 even in f32, 1 at each
    row's max, and its sub-layer moves from D's by bf16 roundings only."""
    x, wqkv, wproj, outs = softmax_case
    qkv = sm.c.gemm(_t(x).reshape(N * S, E), _t(wqkv))
    assert torch.equal(sm.attn_variant(qkv, N, S, H, "D"),
                       tfb._mhsa_ref(qkv, N, S, H))
    _, p = sm.attn_variant(qkv, N, S, H, "E", want_p=True)
    assert torch.equal(p.to(torch.bfloat16).to(p.dtype), p)
    assert torch.equal(p.amax(-1), torch.ones(N, H, S))
    _close(outs["E"], outs["D"], 1e-2, "E vs D")


# -- row 21: split-CLS ---------------------------------------------------------


@pytest.fixture(scope="module")
def split_case():
    rng = np.random.default_rng(1)
    qkv = (rng.standard_normal((N, S, 3 * E)) * 0.3).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(N=N, S=S, E=E, H=H, HD=E // H).items():
            mp.setattr(jsc, name, value)
        outs = {"base": np.asarray(jsc.run(jsc._mhsa_base, jnp.asarray(qkv))),
                "split": np.asarray(jsc.run(jsc._mhsa_split,
                                            jnp.asarray(qkv)))}
    return qkv, outs


@pytest.mark.parametrize("layout", ["base", "split"])
def test_split_cls_matches_tool_kernel(split_case, layout):
    qkv, outs = split_case
    t = _t(qkv).reshape(N * S, 3 * E)
    out = sc.LAYOUTS[layout](t, N, S, H).reshape(N, S, E)
    _close(out.numpy(), outs[layout], REL, layout)
    # the chain runs the core DEPTH times on the same qkv
    assert torch.equal(sc.chain(t, layout, N, S, H, depth=3),
                       sc.LAYOUTS[layout](t, N, S, H))


def test_split_cls_plain_versions_agree_with_each_other(split_case):
    """The two layouts compute the same attention; only their rounding
    points differ (the CLS term of the patch rows stays f32 in split)."""
    qkv, _ = split_case
    t = _t(qkv).reshape(N * S, 3 * E)
    _close(sc.split_ref(t, N, S, H).numpy(),
           tfb._mhsa_ref(t, N, S, H).numpy(), REL)


# -- rows 19-20: int8 scores and context --------------------------------------


@pytest.fixture(scope="module")
def i8_case():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((N, S, E)) * 4.0).astype(np.float32)
    wqkv, wproj = bi.weights(E, seed=3)
    ops = [np.full((1, E), 8.0, np.float32), np.zeros((1, E), np.float32),
           wqkv, np.full((1, 3 * E), 2e-3, np.float32),
           np.zeros((1, 3 * E), np.float32), wproj,
           np.full((1, E), 2e-3, np.float32), np.zeros((1, E), np.float32)]
    jops = [jnp.asarray(o) for o in ops]
    outs = {v: np.asarray(_call(jbi.make_kernel(v, H), jnp.asarray(x), jops))
            for v in bi.VARIANTS}
    mirror = np.asarray(jdbg.xla_ref(jnp.asarray(x), *jops, H))
    return x, bi.params("cpu", wqkv, wproj), outs, mirror


@pytest.mark.parametrize("variant", list(bi.VARIANTS))
def test_attn_i8_matches_tool_kernel(i8_case, variant):
    x, p, outs, _ = i8_case
    out = bi.sublayer(_t(x), p, H, variant)
    _close(out.numpy(), outs[variant], REL_I8, variant)
    two = bi.chain(_t(x), p, H, variant, depth=2)
    _close(two.numpy(),
           (bi.sublayer(out * 0.5, p, H, variant) * 0.5).numpy(), 0.0)


def test_debug_mirror_matches_xla_ref(i8_case):
    x, p, _, mirror = i8_case
    ours = dbg.plain_mirror(_t(x), p, H)
    _close(ours.numpy(), mirror, REL_I8)
    # variant A rounds q / k / v and p to bf16 nowhere here (f32): it is the
    # mirror up to the softmax's own form
    _close(bi.sublayer(_t(x), p, H, "A").numpy(), mirror, REL_I8)


# -- row 17: one block in one program or two ------------------------------------


@pytest.fixture(scope="module")
def block_case():
    rng = np.random.default_rng(4)
    ff = 4 * E
    x = (rng.standard_normal((N, S, E)) * 0.3).astype(np.float32)

    def r(*shape, scale=0.05, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    # nonzero LN and bias operands, so that each one is checked
    attn = [r(1, E, scale=0.1, off=1.0), r(1, E, scale=0.1), r(E, 3 * E),
            r(1, 3 * E, scale=0.1), r(E, E), r(1, E, scale=0.1)]
    mlp = [r(1, E, scale=0.1, off=1.0), r(1, E, scale=0.1), r(E, ff),
           r(1, ff, scale=0.1), r(ff, E), r(1, E, scale=0.1)]
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(N=N, S=S, E=E, H=H, HD=E // H,
                                FF=ff).items():
            mp.setattr(jbf, name, value)
        ja, jm = [jnp.asarray(o) for o in attn], [jnp.asarray(o) for o in mlp]
        xj = jnp.asarray(x)
        outs = {"split": np.asarray(jbf.call(jbf._mlp_kernel, jbf.call(
                    jbf._attn_kernel, xj, ja), jm)),
                "block": np.asarray(jbf.call(jbf._block_kernel, xj, ja + jm))}
    names = ("ln1s", "ln1b", "wqkv", "bqkv", "wproj", "bproj", "ln2s", "ln2b",
             "w1", "b1", "w2", "b2")
    p = dict(zip(names, (_t(o.reshape(-1) if o.shape[0] == 1 else o)
                         for o in attn + mlp)))
    return x, SimpleNamespace(**p), outs


@pytest.mark.parametrize("layout", ["split", "block"])
def test_block_fusion_matches_tool_kernels(block_case, layout):
    x, p, outs = block_case
    out = bf.LAYOUTS[layout](_t(x), p, H)
    _close(out.numpy(), outs[layout], REL, layout)
    _close(bf.block_ref(_t(x), p, H).numpy(), outs[layout], REL, "plain")
    _close(bf.chain(_t(x), p, layout, depth=2, num_heads=H).numpy(),
           bf.LAYOUTS[layout](out, p, H).numpy(), 0.0)


# -- the mains run on the card only ---------------------------------------------


@pytest.mark.parametrize("module", [sm, sc, bi, dbg, bf, ld, ss],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_main_refuses_without_cuda(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main()
