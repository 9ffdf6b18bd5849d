"""The port's MST-DINOv3 configuration (2D RoPE in the attention kernels) on
CPU tensors against `mst_tpu`, in f32 on the same numpy inputs:

- `ops/rotary.py` against `mst_tpu.ops.rotary`;
- the RoPE sub-layers (serving, CLS row, rollout carry, Abnar factor, and
  the train sub-layer's forward residuals, backward and grads) against the
  Pallas kernels in interpret mode, `_attn_rope_ref` and `jax.grad`;
- `dino_v3_classifier_slice` (E=32, 2 heads of dim 16, 2 blocks, 2
  registers, 32-px slices, patch 16) against the JAX fused forward and the
  flax model: logits, loss and grads, saliency in every plane mode, the
  parameter round trip;
- the train CLI's run folder rebuilt with its 4 registers, and the routing
  of the RoPE sub-layers (DINOv3 only).

On the CPU every kernel wrapper takes its plain version, so these tests pin
the plain versions the CUDA kernels are checked against on the card
(`chip_smoke.py`)."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import dino_v3_classifier_slice as jax_dinov3
from mst_tpu.models.vit_fast import fused_mst_logits as jax_fused_mst_logits
from mst_tpu.models.vit_fast import fused_mst_saliency as jax_fused_saliency
from mst_tpu.ops import fused_block as jfb
from mst_tpu.ops import rotary as jrot
from mst_tpu_torch import serve
from mst_tpu_torch.models import layers
from mst_tpu_torch.models.convert import (
    flax_params_from_torch,
    params_from_flax,
    random_flax_params,
)
from mst_tpu_torch.models.mst import (
    dino_v2_classifier_slice,
    dino_v3_classifier_slice,
)
from mst_tpu_torch.models.vit_fast import (
    FastViTConfig,
    fused_mst_logits,
    fused_mst_saliency,
    fused_vit_cls,
)
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import rotary as trot
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import cross_entropy_loss
from mst_tpu_torch.utils.checkpoint import load_hparams

N, E, HEADS, HD = 2, 32, 2, 16
GRID, PREFIX = (2, 2), 3  # CLS + 2 registers + 2x2 patches
S = PREFIX + GRID[0] * GRID[1]
EPS = 1e-5  # the DINOv3 ViT's LN eps
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)  # tests/test_fused_block.py:674
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_fused_block.py:452
MODEL_GRAD_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_trainer.py
PROB_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_fused_block.py:470
SAL_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_fused_block.py:472
TINY_V3 = dict(model_size="tiny", fusion_heads=4, num_register_tokens=2)
MODES = ("last", "rollout", "rollout_abnar")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(ours, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol,
                               err_msg=what)


def _no_launches():
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch
    assert set(tfb.sublayer_calls().values()) == {0}


# -- ops/rotary.py ------------------------------------------------------------


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("grid,prefix", [((2, 2), 3), ((14, 14), 5),
                                         ((3, 5), 1)])
def test_rope_2d_angles_match_mst_tpu(grid, prefix, normalized):
    ang = trot.rope_2d_angles(grid, 64, prefix, 100.0, normalized)
    ref = jrot.rope_2d_angles(grid, 64, num_prefix=prefix, theta=100.0,
                              normalized=normalized)
    assert ang.dtype == torch.float32
    np.testing.assert_array_equal(ang.numpy(), np.asarray(ref))
    assert float(ang[:prefix].abs().max()) == 0.0  # prefix rows: identity
    cos, sin = trot.rope_tables(grid, 64, prefix, 100.0, normalized, "cpu")
    np.testing.assert_allclose(cos.numpy(), np.asarray(jnp.cos(ref)),
                               atol=2e-7, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jnp.sin(ref)),
                               atol=2e-7, rtol=0)


def test_apply_rope_matches_mst_tpu():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 16)).astype(
        np.float32)
    ang = trot.rope_angles(7, 16)
    np.testing.assert_array_equal(ang.numpy(),
                                  np.asarray(jrot.rope_angles(7, 16)))
    _close(trot.apply_rope(_t(x), ang),
           jrot.apply_rope(_j(x), jrot.rope_angles(7, 16)), dict(atol=1e-6,
                                                                 rtol=1e-6))


# -- the RoPE sub-layers against the Pallas kernels (interpret mode) --------


def _attn_inputs(seed, with_ls):
    """x, upstream g, the sub-layer's parameters (O(1) LayerScale), a carry
    that is not one-hot, and the RoPE tables of a 2x2 grid with 3 prefix
    tokens, as numpy f32."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x, g = r(N, S, E), r(N, S, E)
    args = (r(E, scale=0.1, off=1.0), r(E, scale=0.1), r(E, 3 * E, scale=0.3),
            r(3 * E, scale=0.1), r(E, E, scale=0.1), r(E, scale=0.1),
            r(E, scale=0.1, off=1.0) if with_ls else None)
    carry = rng.uniform(0.0, 1.0, (N, HEADS, S)).astype(np.float32)
    cos, sin = trot.rope_tables(GRID, HD, PREFIX, 100.0, True, "cpu")
    return x, g, args, carry, (cos.numpy(), sin.numpy())


def _assert_outputs(out, ref, tol=TOL):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        assert tuple(o.shape) == tuple(r.shape), i
        _close(o.numpy(), r, tol, what=f"output {i}")


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_sublayer_matches_mst_tpu(with_ls):
    x, _, args, _, rope = _attn_inputs(0, with_ls)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer_rope(_t(x), *map(_t, args),
                                            *map(_t, rope), HEADS, EPS)
    _no_launches()
    ref = jfb.fused_attention_sublayer_rope(_j(x), *map(_j, args),
                                            *map(_j, rope), HEADS, EPS)
    xla = jfb._attn_rope_ref(_j(x), *map(_j, args), *map(_j, rope),
                             num_heads=HEADS, eps=EPS)
    _assert_outputs(out, ref)
    _assert_outputs(out, xla)
    # the rotation moves the result: RoPE is not the identity here
    plain = tfb.fused_attention_sublayer(_t(x), *map(_t, args), HEADS, EPS)
    assert float((plain - out).abs().max()) > 1e-3


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_with_row_sublayer_matches_mst_tpu(with_ls):
    x, _, args, _, rope = _attn_inputs(1, with_ls)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer_rope_with_row(
        _t(x), *map(_t, args), *map(_t, rope), HEADS, EPS)
    _no_launches()
    ref = jfb.fused_attention_sublayer_rope_with_row(
        _j(x), *map(_j, args), *map(_j, rope), HEADS, EPS)
    _assert_outputs(out, ref)
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("want_row", [False, True])
@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_rollout_sublayer_chained_twice_matches_mst_tpu(with_ls,
                                                             want_row):
    """Two blocks: the second is fed the first's carry (not one-hot)."""
    x, _, args, carry, rope = _attn_inputs(2, with_ls)
    x2 = np.random.default_rng(12).standard_normal(x.shape).astype(
        np.float32)
    outs = []
    for mod, cv in ((tfb, _t), (jfb, _j)):
        tables = dict(rope_cos=cv(rope[0]), rope_sin=cv(rope[1]))
        y1, c1 = mod.fused_attention_sublayer_rollout(
            cv(x), *map(cv, args), cv(carry), HEADS, EPS, **tables)
        outs.append((y1, c1, *mod.fused_attention_sublayer_rollout(
            cv(x2), *map(cv, args), c1, HEADS, EPS, want_row=want_row,
            **tables)))
    _assert_outputs(*outs)
    np.testing.assert_allclose(outs[0][-1].sum(-1).numpy(), carry.sum(-1),
                               rtol=1e-5)


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_abnar_sublayer_matches_mst_tpu(with_ls):
    x, _, args, _, rope = _attn_inputs(3, with_ls)
    out = tfb.fused_attention_sublayer_abnar(
        _t(x), *map(_t, args), HEADS, EPS, rope_cos=_t(rope[0]),
        rope_sin=_t(rope[1]))
    ref = jfb.fused_attention_sublayer_abnar(
        _j(x), *map(_j, args), HEADS, EPS, rope_cos=_j(rope[0]),
        rope_sin=_j(rope[1]))
    _assert_outputs(out, ref)
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-6)


def test_rope_sublayers_refuse_half_a_table():
    x, _, args, carry, rope = _attn_inputs(4, True)
    with pytest.raises(ValueError, match="rope_cos and rope_sin"):
        tfb.fused_attention_sublayer_abnar(_t(x), *map(_t, args), HEADS,
                                           rope_cos=_t(rope[0]))
    with pytest.raises(ValueError, match="rope_cos and rope_sin"):
        tfb.mhsa_bwd(torch.zeros(N * S, 3 * E), torch.zeros(N * S, E),
                     torch.zeros(N * S, E), torch.zeros(N * S, HEADS), N, S,
                     HEADS, rope_sin=_t(rope[1]))


# -- the RoPE train sub-layer -------------------------------------------------


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_train_forward_and_residuals_match_mst_tpu(with_ls):
    x, _, args, _, rope = _attn_inputs(5, with_ls)
    y, (h, qkv, o, lse) = tfb._attn_train_fwd(
        tfb.KERNELS, _t(x), *map(_t, args), HEADS, EPS, *map(_t, rope))
    jy, jqkv, jo, jb = jfb._attn_train_fwd_impl(
        _j(x), *map(_j, args), HEADS, EPS, rope=tuple(map(_j, rope)))
    _close(y, jy, what="y")
    _close(qkv.reshape(N, S, 3 * E), jqkv, what="qkv (pre-rope)")
    _close(o.reshape(N, S, E), jo, what="o")
    _close(lse.reshape(N, S, HEADS), jb, what="lse")
    _close(h, jfb._ln(_j(x), _j(args[0]), _j(args[1]), EPS).reshape(-1, E),
           what="h")


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_backward_matches_mst_tpu_on_the_same_residuals(with_ls):
    """The port's plain RoPE backward vs `_attn_train_bwd_pallas(rope=)`
    (the Pallas `_attn_bwd_kernel` with `has_rope`, interpret mode), both
    fed JAX's forward residuals and the same g."""
    x, g, args, _, rope = _attn_inputs(6, with_ls)
    ln_s, ln_b, wqkv, bqkv, wproj, bproj, ls = args
    jrope = tuple(map(_j, rope))
    _, jqkv, jo, jb = jfb._attn_train_fwd_impl(_j(x), *map(_j, args), HEADS,
                                               EPS, rope=jrope)
    ref = jfb._attn_train_bwd_pallas(
        HEADS, (_j(x), jqkv, jo, jb, *map(_j, args)), _j(g), eps=EPS,
        rope=jrope)
    h = tfb._ln(_t(x), _t(ln_s), _t(ln_b), EPS).reshape(-1, E)
    res = (h, _t(jqkv).reshape(-1, 3 * E), _t(jo).reshape(-1, E),
           _t(jb).reshape(-1, HEADS))
    ours = tfb._attn_train_bwd(tfb.KERNELS, _t(g), _t(x), res, _t(ln_s),
                               _t(wqkv), _t(wproj), _t(bproj), _t(ls), HEADS,
                               EPS, *map(_t, rope))
    names = ("dx", "dln_s", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dls")
    for name, a, b in zip(names, ours, ref):
        if b is None:
            assert a is None, name
            continue
        _close(a.reshape(b.shape), b, what=name)


@pytest.mark.parametrize("with_ls", [False, True])
def test_rope_train_sublayer_grads_match_jax_grad(with_ls):
    """Every argument's grad vs jax.grad of `_attn_rope_ref` (template
    tests/test_fused_block.py:630), and no grad for the tables."""
    x, _, args, _, rope = _attn_inputs(7, with_ls)
    live = [i for i, a in enumerate(args) if a is not None]
    tx = _t(x).requires_grad_(True)
    targs = [None if a is None else _t(a).requires_grad_(True) for a in args]
    cos, sin = map(_t, rope)
    tfb.reset_launch_counts()
    y = tfb.fused_attention_sublayer_train_rope(tx, *targs, cos, sin, HEADS,
                                                EPS)
    (y ** 2).sum().backward()
    _no_launches()
    ours = [tx.grad] + [targs[i].grad for i in live]

    def loss(x_, *live_args):
        full = [None] * len(args)
        for i, a in zip(live, live_args):
            full[i] = a
        return jnp.sum(jfb._attn_rope_ref(x_, *full, *map(_j, rope),
                                          num_heads=HEADS, eps=EPS) ** 2)

    ref = jax.grad(loss, tuple(range(1 + len(live))))(
        _j(x), *[_j(args[i]) for i in live])
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == torch.float32
        _close(a, b, GRAD_TOL, what=f"arg {i}")
    # `ops=PLAIN` runs the same composition, forward and grads
    tx2 = _t(x).requires_grad_(True)
    y2 = tfb.fused_attention_sublayer_train_rope(
        tx2, *[None if a is None else _t(a) for a in args], cos, sin, HEADS,
        EPS, ops=tfb.PLAIN)
    (y2 ** 2).sum().backward()
    assert torch.equal(y.detach(), y2.detach())
    assert torch.equal(tx.grad, tx2.grad)


# -- the model ------------------------------------------------------------------


def _pair(shape, seed=0, mask=None, **kw):
    """(jax model, flat flax params from a flax `init` with O(1)
    LayerScale, port model with the same weights, volume, targets)."""
    kw = dict(TINY_V3, **kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jax_dinov3(out_ch=2, use_flash=False, **kw)
    init_m = None if mask is None else jnp.asarray(mask[:, :2])
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2]),
                     init_m)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(dino_v3_classifier_slice(out_ch=2, **kw), flat)
    return jm, flat, tm, x, np.arange(shape[0]) % 2


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _mask(b, d):
    m = np.zeros((b, d), bool)
    m[0, -2:] = True  # the first volume's last two slices are padding
    return m


@pytest.mark.parametrize("with_mask", [False, True])
def test_dinov3_logits_match_mst_tpu_and_flax(with_mask):
    shape = (2, 1, 4, 32, 32)
    mask = _mask(2, 4) if with_mask else None
    jm, flat, tm, x, _ = _pair(shape, mask=mask)
    assert tm.encoder.register_tokens.shape[1] == 2
    assert not hasattr(tm.encoder, "pos_embed")
    jmask = _j(mask)
    ref_fused = jax_fused_mst_logits(_tree(flat), jnp.asarray(x), jm,
                                     src_key_padding_mask=jmask,
                                     dtype=jnp.float32)
    ref_flax = jm.apply({"params": _tree(flat)}, jnp.asarray(x), jmask)
    tfb.reset_launch_counts()
    with torch.no_grad():
        out = fused_mst_logits(tm, _t(x), _t(mask)).numpy()
    _no_launches()
    _close(out, ref_fused, MODEL_TOL)
    _close(out, ref_flax, MODEL_TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_dinov3_loss_and_grads_match_flax(with_mask):
    """CE of the fused train forward (the RoPE train sub-layers, the
    CLS-only last block with RoPE) and every parameter's grad vs
    jax.value_and_grad of the flax model."""
    shape = (2, 1, 3, 32, 32)
    mask = _mask(2, 3) if with_mask else None
    jm, flat, tm, x, t = _pair(shape, seed=1, mask=mask)

    def loss_flax(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), _j(mask))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(t)).mean()

    jloss, jgrads = jax.value_and_grad(loss_flax)(_tree(flat))
    loss = cross_entropy_loss(fused_mst_logits(tm, _t(x), _t(mask),
                                               train=True), _t(t))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    jflat = flatten_dict(jgrads, sep="/")
    named = dict(tm.named_parameters())
    assert {k.replace(".", "/") for k in named} == set(jflat)
    for name, p in named.items():
        _close(p.grad.numpy(), jflat[name.replace(".", "/")], MODEL_GRAD_TOL,
               what=name)


@pytest.mark.parametrize("plane_mode", MODES)
def test_dinov3_saliency_matches_mst_tpu(plane_mode):
    """`fused_mst_saliency` with RoPE in each plane mode vs the JAX
    `fused_mst_saliency` (its Pallas RoPE kernels in interpret mode), with
    a padding mask; the map drops the 3 prefix tokens."""
    shape = (2, 1, 4, 32, 32)
    mask = _mask(2, 4)
    jm, flat, tm, x, _ = _pair(shape, seed=2)
    ref_p, ref_s = jax_fused_saliency(_tree(flat), jnp.asarray(x), jm,
                                      _j(mask), dtype=jnp.float32,
                                      plane_mode=plane_mode)
    tfb.reset_launch_counts()
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(x), _t(mask),
                                        plane_mode=plane_mode)
    _no_launches()
    assert tuple(sal.shape) == (2, 4, 32, 32)
    _close(probs.numpy(), ref_p, PROB_TOL)
    _close(sal.numpy(), ref_s, SAL_TOL)
    assert float(sal[0, -2:].abs().max()) < 1e-12


def test_dinov3_no_cheap_last_row_matches_cheap_last_row(monkeypatch):
    """MST_NO_CHEAP_LAST runs block 1 in full through the RoPE `with_row`
    sub-layer; it must give the CLS-only last block's row and feature."""
    _, _, tm, _, _ = _pair((1, 1, 2, 32, 32), seed=3)
    cfg = FastViTConfig.from_model(tm)
    x = _t(np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(
        np.float32))
    with torch.inference_mode():
        monkeypatch.delenv("MST_NO_CHEAP_LAST", raising=False)
        cls_c, row_c = fused_vit_cls(tm.encoder, x, cfg, torch.float32,
                                     want_last_row=True)
        monkeypatch.setenv("MST_NO_CHEAP_LAST", "1")
        cls_f, row_f = fused_vit_cls(tm.encoder, x, cfg, torch.float32,
                                     want_last_row=True)
    assert tuple(row_f.shape) == (3, cfg.num_heads, S)
    torch.testing.assert_close(row_f, row_c, **TOL)
    torch.testing.assert_close(cls_f, cls_c, **TOL)


def test_dinov3_flax_params_round_trip():
    """flax `init` of `dino_v3_classifier_slice` (no pos_embed, with
    register tokens) -> params_from_flax -> flax_params_from_torch gives the
    same flat tree, which flax applies as it is; `random_flax_params` draws
    the same names and shapes."""
    jm, flat, tm, x, _ = _pair((1, 1, 2, 32, 32), seed=5)
    assert not any(k.endswith("pos_embed") for k in flat)
    assert "encoder/register_tokens" in flat
    back = flax_params_from_torch(tm)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    np.testing.assert_array_equal(
        np.asarray(jm.apply({"params": _tree(back)}, jnp.asarray(x))),
        np.asarray(jm.apply({"params": _tree(flat)}, jnp.asarray(x))))
    drawn = random_flax_params(tm, 7)
    assert {k: v.shape for k, v in drawn.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_train_cli_dinov3_run_folder_rebuilds_with_4_registers(tmp_path):
    """`python -m mst_tpu_torch.train --model DinoV3ClassifierSlice` through
    its builders: without --use_registers the model keeps DINOv3's 4
    registers, the run's hparams record them, and `serve.load_run_model`
    rebuilds the same model, which predicts what the trained one does."""
    args = cli.parse_args(["--dataset", "Synthetic", "--model",
                           "DinoV3ClassifierSlice", "--dtype", "float32",
                           "--max_epochs", "1", "--batch_size", "2",
                           "--num_train_samples", "4", "--lr", "1e-3"])
    assert "num_register_tokens" not in cli.model_kwargs(args)
    model = get_model(args.model, model_size="tiny", fusion_heads=4,
                      **cli.model_kwargs(args))
    assert model.num_register_tokens == 4
    dm = cli.build_datamodule(args, "cpu", shape_cdhw=(1, 2, 32, 32),
                              num_samples=4)
    trainer = cli.build_trainer(args, dm, run_dir=tmp_path)
    _, result = cli.train(args, model, dm, trainer)
    hp = load_hparams(tmp_path)
    assert hp["model"] == "DinoV3ClassifierSlice"
    assert hp["num_register_tokens"] == 4 and hp["use_rope_2d"]
    assert hp["use_pos_embed"] is False and hp["norm_eps"] == 1e-5
    json.dumps(hp)  # the run folder's file holds it
    served = serve.load_run_model(tmp_path).eval()
    assert served.encoder.register_tokens.shape[1] == 4
    assert served.config == model.config
    server, predictor = serve.build_server(serve.parse_args(
        ["--run_folder", str(tmp_path), "--port", "0", "--dtype", "float32"]),
        served)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert json.loads(r.read())["model"] == "DinoV3ClassifierSlice"
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()
    vol = _t(np.random.default_rng(6).standard_normal(
        (2, 1, 2, 32, 32)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused_mst_logits(served, vol),
                                   fused_mst_logits(model, vol),
                                   atol=0, rtol=0)
    # DINOv2 keeps 0 registers unless asked, 4 with --use_registers
    for flags, want in (([], 0), (["--use_registers"], 4)):
        a = cli.parse_args(["--dataset", "Synthetic", *flags])
        assert get_model(a.model, model_size="tiny", fusion_heads=4,
                         **cli.model_kwargs(a)).num_register_tokens == want


_ROPE_SUBLAYERS = ("fused_attention_sublayer_rope",
                   "fused_attention_sublayer_rope_with_row",
                   "fused_attention_sublayer_train_rope")


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_rope_sublayers_run_for_dinov3_only(version, monkeypatch):
    """Which attention sub-layers the blocks call in the serving forward,
    the train step and every saliency mode: DINOv2 never a RoPE form and
    never a table, DINOv3 only RoPE forms."""
    build = dino_v2_classifier_slice if version == "v2" else \
        dino_v3_classifier_slice
    tm = build(out_ch=2, model_size="tiny", fusion_heads=4,
               **({"patch_size": 16} if version == "v2" else {}))
    params_from_flax(tm, random_flax_params(tm, 0))
    seen = []

    def spy(name):
        fn = getattr(layers, name)

        def wrapped(*a, **kw):
            tables = [v for v in (*a, *kw.values())
                      if torch.is_tensor(v) and v.dim() == 2
                      and v.shape[-1] == HD and v.shape[0] != E]
            seen.append((name, bool(tables) or "rope" in name))
            return fn(*a, **kw)
        monkeypatch.setattr(layers, name, wrapped)

    for name in ("fused_attention_sublayer", "fused_attention_sublayer_train",
                 "fused_attention_sublayer_with_row",
                 "fused_attention_sublayer_rollout",
                 "fused_attention_sublayer_abnar", *_ROPE_SUBLAYERS):
        spy(name)
    vol = _t(np.random.default_rng(8).standard_normal(
        (1, 1, 2, 32, 32)).astype(np.float32))
    with torch.no_grad():
        fused_mst_logits(tm, vol)
        for mode in MODES:
            fused_mst_saliency(tm, vol, plane_mode=mode)
    fused_mst_logits(tm, vol, train=True).sum().backward()
    monkeypatch.setenv("MST_NO_CHEAP_LAST", "1")
    with torch.no_grad():
        fused_mst_saliency(tm, vol, plane_mode="last")
    names = {n for n, _ in seen}
    assert len(names) == 5  # serving, train, with_row, rollout, abnar
    assert all(rope == (version == "v3") for _, rope in seen), seen
