"""The port's train sub-layers (`mst_tpu_torch.ops.fused_block`
`fused_*_sublayer_train`: residual-saving forward + hand-written backward)
on CPU tensors against `mst_tpu`'s train kernels (Pallas in interpret mode)
and `jax.grad`, in f32 on the same numpy inputs.

On the CPU every kernel wrapper takes its plain version, inside the same
`torch.autograd.Function` the card runs, so these tests pin the forward
residuals AND the backward math that the CUDA kernels are held to on the
card (`chip_smoke.py`); autograd never differentiates the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.ops import fused_block as tfb

N, S, E, HEADS, F = 2, 9, 32, 4, 64
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)  # as tests/test_fused_block.py:111
EPS = [1e-6, 1e-5]


def _inputs(seed, hidden, out_in, with_ls):
    """x, upstream g and (ln_s, ln_b, w_in [E, hidden], b_in, w_out
    [out_in, E], b_out, ls | None) as numpy f32; O(1) LayerScale."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x, g = r(N, S, E), r(N, S, E)
    args = (r(E, scale=0.1, off=1.0), r(E, scale=0.1),
            r(E, hidden, scale=0.1), r(hidden, scale=0.1),
            r(out_in, E, scale=0.1), r(E, scale=0.1),
            r(E, scale=0.1, off=1.0) if with_ls else None)
    return x, g, args


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(ours, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol,
                               err_msg=what)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_attention_train_forward_and_residuals_match_mst_tpu(with_ls, eps):
    x, _, args = _inputs(0, 3 * E, E, with_ls)
    y, (h, qkv, o, lse) = tfb._attn_train_fwd(
        tfb.KERNELS, _t(x), *map(_t, args), HEADS, eps)
    jy, jqkv, jo, jb = jfb._attn_train_fwd_impl(_j(x), *map(_j, args), HEADS,
                                                eps)
    _close(y, jy, what="y")
    _close(qkv.reshape(N, S, 3 * E), jqkv, what="qkv")
    _close(o.reshape(N, S, E), jo, what="o")
    _close(lse.reshape(N, S, HEADS), jb, what="lse")  # [N, S, heads]
    _close(h, jfb._ln(_j(x), _j(args[0]), _j(args[1]), eps).reshape(-1, E),
           what="h")


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_mlp_train_forward_and_residuals_match_mst_tpu(with_ls, approximate,
                                                       eps):
    x, _, args = _inputs(1, F, F, with_ls)
    y, (h, a, u) = tfb._mlp_train_fwd(tfb.KERNELS, _t(x), *map(_t, args),
                                      approximate, eps)
    jy, ja = jfb._mlp_train_fwd_impl(_j(x), *map(_j, args), approximate, eps)
    _close(y, jy, what="y")
    _close(a.reshape(N, S, F), ja, what="a")
    _close(u, jax.nn.gelu(ja, approximate=approximate).reshape(-1, F),
           what="u")


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_attention_backward_matches_mst_tpu_on_the_same_residuals(with_ls,
                                                                  eps):
    """The port's plain backward vs `_attn_train_bwd_pallas` (the Pallas
    `_attn_bwd_kernel` in interpret mode), both fed JAX's forward
    residuals and the same g."""
    x, g, args = _inputs(2, 3 * E, E, with_ls)
    ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls = args
    _, jqkv, jo, jb = jfb._attn_train_fwd_impl(_j(x), *map(_j, args), HEADS,
                                               eps)
    ref = jfb._attn_train_bwd_pallas(
        HEADS, (_j(x), jqkv, jo, jb, *map(_j, args)), _j(g), eps=eps)
    h = tfb._ln(_t(x), _t(ln_s), _t(ln_b), eps).reshape(-1, E)
    res = (h, _t(jqkv).reshape(-1, 3 * E), _t(jo).reshape(-1, E),
           _t(jb).reshape(-1, HEADS))
    ours = tfb._attn_train_bwd(tfb.KERNELS, _t(g), _t(x), res, _t(ln_s),
                               _t(wqkv), _t(wproj), _t(bproj), _t(ls), HEADS,
                               eps)
    names = ("dx", "dln_s", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dls")
    for name, a, b in zip(names, ours, ref):
        if b is None:
            assert a is None, name
            continue
        _close(a.reshape(b.shape), b, what=name)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_mlp_backward_matches_mst_tpu_on_the_same_residuals(with_ls,
                                                            approximate, eps):
    x, g, args = _inputs(3, F, F, with_ls)
    ln_s, ln_b, w1, b1, w2, b2, ls = args
    _, ja = jfb._mlp_train_fwd_impl(_j(x), *map(_j, args), approximate, eps)
    ref = jfb._mlp_train_bwd_pallas(
        approximate, (_j(x), ja, *map(_j, args)), _j(g), eps=eps)
    h = tfb._ln(_t(x), _t(ln_s), _t(ln_b), eps).reshape(-1, E)
    a = _t(ja).reshape(-1, F)
    u = torch.nn.functional.gelu(a, approximate="tanh" if approximate
                                 else "none")
    ours = tfb._mlp_train_bwd(tfb.KERNELS, _t(g), _t(x), (h, a, u), _t(ln_s),
                              _t(w1), _t(w2), _t(b2), _t(ls), approximate,
                              eps)
    names = ("dx", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dls")
    for name, o, r in zip(names, ours, ref):
        if r is None:
            assert o is None, name
            continue
        _close(o.reshape(r.shape), r, what=name)


def _grads(fn_t, fn_j, x, args):
    """(torch autograd grads, jax.grad grads) of sum(y ** 2) in x and every
    non-None argument."""
    live = [i for i, a in enumerate(args) if a is not None]
    tx = _t(x).requires_grad_(True)
    targs = [None if a is None else _t(a).requires_grad_(True) for a in args]
    tfb.reset_launch_counts()
    (fn_t(tx, *targs) ** 2).sum().backward()
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch
    ours = [tx.grad] + [targs[i].grad for i in live]

    def loss(x_, *live_args):
        full = [None] * len(args)
        for i, a in zip(live, live_args):
            full[i] = a
        return jnp.sum(fn_j(x_, *full) ** 2)

    ref = jax.grad(loss, tuple(range(1 + len(live))))(
        _j(x), *[_j(args[i]) for i in live])
    return ours, ref


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_attention_train_sublayer_grads_match_jax_grad(with_ls, eps):
    """Every argument's grad vs jax.grad of `fused_attention_sublayer_train`
    (its Pallas forward and backward in interpret mode)."""
    x, _, args = _inputs(4, 3 * E, E, with_ls)
    ours, ref = _grads(
        lambda *a: tfb.fused_attention_sublayer_train(*a, HEADS, eps),
        lambda *a: jfb.fused_attention_sublayer_train(*a, HEADS, eps),
        x, args)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == torch.float32
        _close(a, b, GRAD_TOL, what=f"arg {i}")


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_mlp_train_sublayer_grads_match_jax_grad(with_ls, approximate, eps):
    x, _, args = _inputs(5, F, F, with_ls)
    ours, ref = _grads(
        lambda *a: tfb.fused_mlp_sublayer_train(*a, approximate, eps),
        lambda *a: jfb.fused_mlp_sublayer_train(*a, approximate, eps),
        x, args)
    for i, (a, b) in enumerate(zip(ours, ref)):
        _close(a, b, GRAD_TOL, what=f"arg {i}")


def test_plain_table_runs_the_same_composition():
    """`ops=PLAIN` (the plain versions on any device, the reference
    `chip_smoke.py` holds the kernels to) equals the default table on CPU,
    forward and grads, bit for bit."""
    x, _, args = _inputs(6, 3 * E, E, True)
    outs = []
    for ops in (tfb.KERNELS, tfb.PLAIN):
        tx = _t(x).requires_grad_(True)
        targs = [_t(a).requires_grad_(True) for a in args]
        y = tfb.fused_attention_sublayer_train(tx, *targs, HEADS, ops=ops)
        (y ** 2).sum().backward()
        outs.append([y.detach(), tx.grad] + [a.grad for a in targs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_mhsa_lse_is_the_log_sum_exp_in_base_2():
    """b = m + log2(l) of the scaled scores, per [slice, query, head]."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((N * S, 3 * E)).astype(
        np.float32))
    _, lse = tfb.mhsa(qkv, N, S, HEADS, want_lse=True)
    hd = E // HEADS
    t = qkv.reshape(N, S, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    sc = t[0] @ t[1].transpose(-1, -2) / hd ** 0.5 * np.log2(np.e)
    ref = torch.logsumexp(sc * np.log(2.0), -1) / np.log(2.0)  # [N, H, S]
    _close(lse.reshape(N, S, HEADS), ref.permute(0, 2, 1))
