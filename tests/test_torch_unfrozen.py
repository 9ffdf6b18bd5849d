"""Unfrozen encoder training in the port (ViT-B/L and giant2 on the card) on
CPU tensors against `mst_tpu`, in f32 on the same numpy inputs:

- the SwiGLU train sub-layer (queue B row 6, `_swiglu_train_kernel`, and
  the port's kernel chain for the XLA `_swiglu_train_bwd`): the forward and
  its residuals, the backward on JAX's residuals, and every argument's grad
  against `jax.grad` of `fused_swiglu_sublayer_train`;
- the LN-pullback route of `gemm_dgrad` (the GEMM's f32 dh, then the row
  kernel `ln_pullback`, which every width takes) inside the attention and
  MLP train sub-layers, against JAX's Pallas backward and,
  with `_PALLAS_BWD_MAX_E` patched to 0, its XLA backward (the one JAX runs
  at E > 1024);
- `remat`: two unfrozen AdamW steps of a `tiny128` SwiGLU model against the
  JAX `make_train_step`, with and without remat on both sides; the port's
  grads bit for bit with and without remat; the train CLI with `--remat`
  through a run folder and `serve.load_run_model`;
- C1: `mhsa_abnar`'s query tile at every sequence length the fused gate
  admits.

On the CPU every kernel wrapper takes its plain version, so these tests pin
the plain versions the CUDA kernels are held to on the card (`chip_smoke.py`
phases 26-30). Tolerances: sub-layer forwards and residuals 2e-5, grads
5e-4 (tests/test_fused_block.py), AdamW updates 5% of lr
(tests/test_torch_trainer.py)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.ops import fused_block as jfb
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu_torch import serve
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import FUSED_MAX_TOKENS, fused_mst_logits
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import (
    TrainState,
    cross_entropy_loss,
    make_optimizer,
    make_train_step,
)
from mst_tpu_torch.utils.checkpoint import load_hparams

N, S, E, HEADS, F = 2, 9, 32, 4, 40  # F: the SwiGLU gate width (w12 2F)
TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_fused_block.py:176 (f32)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)  # tests/test_fused_block.py:111
EPS = [1e-6, 1e-5]
GATED = dict(model_size="tiny128", ffn_layer="swiglu", patch_size=14,
             fusion_heads=4)  # E = 128, 2 heads, F = 344 by the 2/3 rule


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(ours, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol,
                               err_msg=what)


def _inputs(seed, hidden, out_in, with_ls):
    """x, upstream g and (ln_s, ln_b, w_in [E, hidden], b_in, w_out
    [out_in, E], b_out, ls | None) as numpy f32; O(1) LayerScale."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x, g = r(N, S, E), r(N, S, E)
    args = (r(E, scale=0.1, off=1.0), r(E, scale=0.1),
            r(E, hidden, scale=0.3), r(hidden, scale=0.1),
            r(out_in, E, scale=0.3), r(E, scale=0.1),
            r(E, scale=0.1, off=1.0) if with_ls else None)
    return x, g, args


def _gate(h12):
    """silu(h1) * h2 of a [M, 2F] pre-gate, in JAX."""
    h1, h2 = jnp.split(h12, 2, axis=-1)
    return h1 * jax.nn.sigmoid(h1) * h2


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


# -- the SwiGLU train sub-layer (queue B row 6) ---------------------------------


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_swiglu_train_forward_and_residuals_match_mst_tpu(with_ls, eps):
    """y and the residuals (h, h12, the gate g of the rounded h12) vs
    `_swiglu_train_fwd_impl` (the Pallas `_swiglu_train_kernel`, interpret
    mode)."""
    x, _, args = _inputs(0, 2 * F, F, with_ls)
    y, (h, h12, g) = tfb._swiglu_train_fwd(tfb.KERNELS, _t(x),
                                           *map(_t, args), eps)
    jy, jh12 = jfb._swiglu_train_fwd_impl(_j(x), *map(_j, args), eps)
    _close(y, jy, what="y")
    _close(h12.reshape(N, S, 2 * F), jh12, what="h12")
    _close(h, jfb._ln(_j(x), _j(args[0]), _j(args[1]), eps).reshape(-1, E),
           what="h")
    _close(g, _gate(jh12).reshape(-1, F), what="g")


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_swiglu_backward_matches_mst_tpu_on_the_same_residuals(with_ls, eps):
    """The port's backward chain (`gemm_dls`, `gemm_wgrad`, `gemm_dgrad`'s
    SiLU-gate epilogue, `gemm_wgrad`, the LN pullback) vs the XLA
    `_swiglu_train_bwd`, both fed JAX's forward residual h12 and the same
    upstream g."""
    x, g, args = _inputs(1, 2 * F, F, with_ls)
    ln_s, ln_b, w12, b12, w3, b3, ls = args
    _, jh12 = jfb._swiglu_train_fwd_impl(_j(x), *map(_j, args), eps)
    ref = jfb._swiglu_train_bwd(eps, (_j(x), jh12, *map(_j, args)), _j(g))
    h = tfb._ln(_t(x), _t(ln_s), _t(ln_b), eps).reshape(-1, E)
    res = (h, _t(jh12).reshape(-1, 2 * F),
           _t(_gate(jh12)).reshape(-1, F))
    ours = tfb._swiglu_train_bwd(tfb.KERNELS, _t(g), _t(x), res, _t(ln_s),
                                 _t(w12), _t(w3), _t(b3), _t(ls), eps)
    names = ("dx", "dln_s", "dln_b", "dw12", "db12", "dw3", "db3", "dls")
    for name, a, b in zip(names, ours, ref):
        if b is None:
            assert a is None, name
            continue
        _close(a.reshape(b.shape), b, what=name)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("with_ls", [False, True])
def test_swiglu_train_sublayer_grads_match_jax_grad(with_ls, eps):
    """Every argument's grad vs jax.grad of `fused_swiglu_sublayer_train`
    (its Pallas forward in interpret mode, its XLA backward); the grads
    leave in f32, the parameters' dtype."""
    x, _, args = _inputs(2, 2 * F, F, with_ls)
    ours, ref = _grads(
        lambda *a: tfb.fused_swiglu_sublayer_train(*a, eps),
        lambda *a: jfb.fused_swiglu_sublayer_train(*a, eps), x, args)
    assert len(ours) == (8 if with_ls else 7)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == torch.float32
        _close(a, b, GRAD_TOL, what=f"arg {i}")


def test_swiglu_derivative_epilogue_rounds_du_first():
    """`gemm_dgrad`'s ACT_SWIGLU epilogue in bf16: du = gz @ w3^T rounded to
    bf16 (the XLA product of `_swiglu_train_bwd`), then the gate's
    derivative in f32 and one cast per output; dh1 at column c, dh2 at
    F + c."""
    rng = np.random.default_rng(3)
    m, f, e = 16, 8, 32
    gz = torch.from_numpy(rng.standard_normal((m, e)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((f, e)).astype(np.float32))
    h12 = torch.from_numpy(rng.standard_normal((m, 2 * f)).astype(np.float32))
    bf = torch.bfloat16
    out = tfb.gemm_dgrad(gz.to(bf), w3.to(bf), a=h12.to(bf),
                         act=tfb.ACT_SWIGLU)
    assert out.shape == (m, 2 * f) and out.dtype == bf
    du = (gz.to(bf).float() @ w3.to(bf).float().t()).to(bf).float()
    h1, h2 = h12.to(bf).float().chunk(2, -1)
    sig = torch.sigmoid(h1)
    want = torch.cat([du * h2 * (sig + h1 * sig * (1 - sig)),
                      du * h1 * sig], -1).to(bf)
    assert torch.equal(out, want)


# -- the LN-pullback route (every width on the card) ---------------------------


def _wide(ops):
    """`ops` with `gemm_dgrad`'s LN epilogue spelt out as the card runs it
    at every width: the GEMM's f32 dh, then `ln_pullback`."""
    def gemm_dgrad(dy, w, a=None, act=tfb.ACT_NONE, ln=None):
        if ln is None:
            return ops.gemm_dgrad(dy, w, a, act)
        return tfb.ln_pullback(tfb._mm(dy, w.t()), *ln)
    return SimpleNamespace(**{**vars(ops), "gemm_dgrad": gemm_dgrad})


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("jax_bwd", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_wide_ln_route_train_sublayer_grads_match_mst_tpu(kind, jax_bwd, eps,
                                                          monkeypatch):
    """The attention and MLP train sub-layers with the LN route vs
    jax.grad of their JAX counterparts: the Pallas `_attn_bwd_kernel` /
    `_mlp_bwd_kernel`, or with `_PALLAS_BWD_MAX_E` patched to 0 (as
    tests/test_fused_block.py:357) `_attn_train_bwd_xla` /
    `_mlp_train_bwd_xla`, the backward JAX runs at E > 1024 (ViT-L's 1024
    takes Pallas, giant2's 1536 XLA)."""
    if jax_bwd == "xla":
        monkeypatch.setattr(jfb, "_PALLAS_BWD_MAX_E", 0)
    wide = _wide(tfb.KERNELS)
    if kind == "attn":
        x, _, args = _inputs(4, 3 * E, E, True)
        fn_t = lambda *a: tfb.fused_attention_sublayer_train(  # noqa: E731
            *a, HEADS, eps, ops=wide)
        fn_j = lambda *a: jfb.fused_attention_sublayer_train(  # noqa: E731
            *a, HEADS, eps)
    else:
        x, _, args = _inputs(5, 4 * E, 4 * E, True)
        fn_t = lambda *a: tfb.fused_mlp_sublayer_train(  # noqa: E731
            *a, True, eps, ops=wide)
        fn_j = lambda *a: jfb.fused_mlp_sublayer_train(  # noqa: E731
            *a, True, eps)
    ours, ref = _grads(fn_t, fn_j, x, args)
    for i, (a, b) in enumerate(zip(ours, ref)):
        _close(a, b, GRAD_TOL, what=f"{kind} arg {i}")


def test_ln_pullback_is_the_ln_epilogue_of_gemm_dgrad():
    """`ln_pullback` from the f32 product equals `gemm_dgrad` with `ln`
    bit for bit (on the card the wrapper launches the f32 product, then
    `ln_pullback`), and the JAX `_ln_bwd` plus the residual to f32
    rounding."""
    rng = np.random.default_rng(6)
    m, r, k = 24, 64, 96
    dy, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((m, r), (k, r)))
    x, g = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
            for _ in range(2))
    ln_s = torch.from_numpy((1 + 0.1 * rng.standard_normal(k)).astype(
        np.float32))
    ln = (x, g, ln_s, 1e-6)
    route = tfb.gemm_dgrad(dy, w, ln=ln)
    wide = tfb.ln_pullback(tfb._mm(dy, w.t()), *ln)
    for a, b in zip(route, wide):
        assert torch.equal(a, b)
    xhat, rstd = jfb._ln_recompute(_j(x)[None], _j(ln_s), 1e-6)
    jdx, jdlns, jdlnb = jfb._ln_bwd(_j((dy @ w.t()).numpy())[None], xhat,
                                    rstd, _j(ln_s))  # [N, S, K] in JAX
    for a, b in zip(wide, (jdx[0] + _j(g), jdlns, jdlnb)):
        _close(a, b)


# -- remat and the unfrozen SwiGLU model ---------------------------------------------


def _pair(shape, seed, **kw):
    """(jax model, flat flax params from a flax `init` with O(1)
    LayerScale, port model with the same weights, volume, targets)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JaxMST(out_ch=2, use_flash=False, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2]))[
        "params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **kw), flat)
    return jm, flat, tm, x, np.arange(shape[0]) % 2


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.mark.parametrize("remat", [False, True])
def test_unfrozen_swiglu_adamw_steps_match_jax_make_train_step(remat):
    """Two AdamW steps of the port's train step on an unfrozen `tiny128`
    SwiGLU model (giant2's block at a test width) vs the JAX
    `make_train_step` (optax adamw), `remat` on both sides: every parameter
    moves as the JAX one does, to 5% of lr (tests/test_torch_trainer.py);
    the key thirds of the packed qkv biases, whose grad is rounding noise,
    stay Adam steps, and so do the few weights whose first grad is below
    f32 rounding of the tensor's largest (1e-6 of it: Adam scales that noise
    up to a step of about lr in either direction, as the key bias's)."""
    lr, wd = 1e-3, 1e-2
    shape = (2, 1, 3, 28, 28)
    jm, flat, tm, x, t = _pair(shape, 7, remat=remat, **GATED)
    assert tm.remat is remat and tm.config["remat"] is remat
    cross_entropy_loss(fused_mst_logits(tm, _t(x), train=True),
                       _t(t)).backward()
    noise = {n_: ((p.grad != 0) & (p.grad.abs() < 1e-6 * p.grad.abs().max())
                  ).numpy() for n_, p in tm.named_parameters()}
    assert sum(m.sum() for m in noise.values()) < 0.01 * sum(
        m.size for m in noise.values())  # ~0.2%, most in the pos-embed
    x2 = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=_tree(flat),
                                  tx=jax_make_optimizer(lr, wd),
                                  dropout_rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, wd))
    step = make_train_step(state)
    tfb.reset_launch_counts()
    for xb in (x, x2):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(xb), jnp.asarray(t), None)
        loss, _ = step(torch.from_numpy(xb), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    assert set(tfb.launch_counts().values()) == {0}
    jflat = flatten_dict(jstate.params, sep="/")
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        ref = np.asarray(jflat[key]) - flat[key]
        adam_only = noise[name].copy()
        if key.endswith(("attn/qkv/bias", "self_attn/in_proj/bias")):
            e = ours.shape[0] // 3  # [q | k | v]
            adam_only[e:2 * e] = True
        assert np.abs(ours[adam_only]).max(initial=0) <= 2 * lr * (
            1.0 + 1e-3), name
        ours, ref = ours[~adam_only], ref[~adam_only]
        assert np.abs(ours).max() > 0.1 * lr, name  # the encoder trains too
        np.testing.assert_allclose(ours, ref, atol=0.05 * lr, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [dict(model_size="tiny", patch_size=14,
                                     fusion_heads=4),
                                dict(GATED, ffn_hidden=64),
                                dict(model_size="tiny", patch_size=16,
                                     fusion_heads=4, use_rope_2d=True,
                                     use_pos_embed=False,
                                     num_register_tokens=4, norm_eps=1e-5)],
                         ids=["mlp", "swiglu", "rope"])
def test_remat_leaves_loss_and_grads_bit_for_bit(kw):
    """`remat=True` only reschedules the backward: the same loss and every
    grad bit for bit in f32, for the MLP, SwiGLU and RoPE block families
    (tests/test_remat.py:69)."""
    rng = np.random.default_rng(9)
    size = 32 if kw.get("patch_size") == 16 else 28
    x = torch.from_numpy(rng.standard_normal((2, 1, 3, size, size)).astype(
        np.float32))
    t = torch.tensor([0, 1])
    out = []
    for remat in (False, True):
        m = get_model("DinoV2ClassifierSlice", remat=remat, **kw)
        params_from_flax(m, random_flax_params(m, 0))
        with torch.no_grad():
            for n_, p in m.named_parameters():
                if n_.endswith(".gamma"):
                    p.fill_(1.0)
        loss = cross_entropy_loss(fused_mst_logits(m, x, train=True), t)
        loss.backward()
        out.append((loss.detach(), {n_: p.grad for n_, p in
                                    m.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("remat", [False, True])
def test_f64_plain_path_is_the_oracle(remat):
    """The oracle `chip_smoke.py` holds the card's steps to: the train
    forward in float64 keeps f64 from the tokens to the logits (the plain
    versions upcast to at least f32), its grads leave in the parameters'
    f32, and its loss and grads agree with the f32 path's to f32
    rounding."""
    m = get_model("DinoV2ClassifierSlice", remat=remat,
                  **dict(GATED, ffn_hidden=64))
    params_from_flax(m, random_flax_params(m, 0))
    with torch.no_grad():
        for n_, p in m.named_parameters():
            if n_.endswith(".gamma"):
                p.fill_(1.0)
    x = _t(np.random.default_rng(12).standard_normal((2, 1, 3, 28, 28))
           .astype(np.float32))
    t = torch.tensor([0, 1])
    logits = fused_mst_logits(m, x, dtype=torch.float64, train=True)
    assert logits.dtype == torch.float64
    loss64 = torch.nn.functional.cross_entropy(logits, t)
    loss64.backward()
    g64 = {n_: p.grad.clone() for n_, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    loss32 = cross_entropy_loss(fused_mst_logits(m, x, train=True), t)
    loss32.backward()
    np.testing.assert_allclose(loss64.item(), loss32.item(), atol=1e-5)
    for n_, p in m.named_parameters():
        assert g64[n_].dtype == torch.float32, n_
        _close(g64[n_], p.grad, dict(atol=1e-5, rtol=2e-4), what=n_)


def test_train_cli_unfrozen_remat_run_folder_serves(tmp_path):
    """`python -m mst_tpu_torch.train --model_size tiny128 --remat`
    (unfrozen, a SwiGLU FFN as giant2's) through its build functions: the
    run's hparams record `remat` and `freeze`, the encoder trained, and
    `serve.load_run_model` rebuilds the model that was trained; --remat is
    refused for a ResNet, as `scripts/main_train.py` refuses it."""
    args = cli.parse_args(["--dataset", "Synthetic", "--model_size",
                           "tiny128", "--remat", "--dtype", "float32",
                           "--max_epochs", "1", "--batch_size", "2",
                           "--num_train_samples", "4", "--lr", "1e-3"])
    assert args.remat and not args.freeze
    model = get_model(args.model, model_size=args.model_size, fusion_heads=4,
                      ffn_layer="swiglu", ffn_hidden=64,
                      **cli.model_kwargs(args))
    assert model.remat and not model.freeze
    dm = cli.build_datamodule(args, "cpu", shape_cdhw=(1, 2, 28, 28),
                              num_samples=4)
    run = tmp_path / "Synthetic" / "DinoV2ClassifierSlice_run"
    trainer = cli.build_trainer(args, dm, run_dir=run)
    cli.train(args, model, dm, trainer)
    hp = load_hparams(run)
    assert hp["remat"] is True and hp["freeze"] is False
    assert hp["ffn_layer"] == "swiglu" and hp["ffn_hidden"] == 64
    drawn = random_flax_params(model, args.seed)
    served = serve.load_run_model(run).eval()
    assert served.config == model.config and served.remat
    assert not np.array_equal(
        served.encoder.blocks_0.mlp.w12.kernel.detach().numpy(),
        drawn["encoder/blocks_0/mlp/w12/kernel"])  # the encoder trained
    vol = _t(np.random.default_rng(10).standard_normal(
        (2, 1, 2, 28, 28)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused_mst_logits(served, vol),
                                   fused_mst_logits(model, vol),
                                   atol=0, rtol=0)
    resnet = cli.parse_args(["--model", "ResNet", "--remat"])
    with pytest.raises(SystemExit, match="--remat"):
        cli.model_kwargs(resnet)


# -- C1: the Abnar factor at every fused sequence length -------------------------


def test_abnar_query_tile_admits_every_fused_length():
    """`mhsa_abnar`'s kernel has a query tile for every S up to
    FUSED_MAX_TOKENS: the forward's 64-row wgmma tile at every length (S =
    442 is ViT-S/14 on 294 px slices). Its f32 head sum lives in shared
    memory up to S = 272 (164,920 bytes at S = 257) and in the factor rows
    each block owns above, within the 232,448 bytes a block may have
    (156,752 at S = 512)."""
    tiles = {s: tfb.abnar_query_tile(s) for s in range(1, FUSED_MAX_TOKENS + 1)}
    assert set(tiles.values()) == {64}
    assert tiles[257] == 64 and tiles[201] == 64 and tiles[442] == 64
    assert tfb.mhsa_launch(257).abnar_smem == 164_920
    assert tfb.mhsa_launch(512).abnar_smem == 156_752
    assert all(tfb.mhsa_launch(s).abnar_smem <= tfb._SMEM_CAP
               for s in range(1, FUSED_MAX_TOKENS + 1))
    # the CPU path runs the Abnar sub-layer at S = 442 as at any length
    qkv = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (442, 3 * 64)).astype(np.float32))
    o, fac = tfb.mhsa_abnar(qkv, 1, 442, 1)
    assert o.shape == (442, 64) and fac.shape == (1, 442, 442)
    torch.testing.assert_close(fac.sum(-1), torch.ones(1, 442))
