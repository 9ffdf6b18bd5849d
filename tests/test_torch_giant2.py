"""The port's SwiGLU FFN (giant2) and frozen-encoder training on CPU tensors
against `mst_tpu`, in f32 on the same numpy inputs:

- `fused_swiglu_sublayer` against the Pallas `_swiglu_kernel` (interpret
  mode) and the XLA `_swiglu_ref`, at the 2/3-rule width and a pinned one,
  with and without LayerScale, at both LN eps;
- `tiny128` with `ffn_layer="swiglu"` (giant2's block at a test width)
  against the JAX fused forward and the flax model: logits with and without
  a mask, saliency in every plane mode; a gated-MLP DINOv3 likewise;
- the full giant2 parameter tree, built on the `meta` device, against
  `jax.eval_shape` of the flax `init`;
- frozen training: two AdamW steps against the JAX `make_train_step` with
  `make_optimizer(freeze_encoder=True)`, and the train CLI's build
  functions with `--freeze` through a run folder, `serve` and `predict`;
- the boundary of what the card's train kernels take (`check_trainable`);
  unfrozen SwiGLU training itself is tests/test_torch_unfrozen.py.

On the CPU every kernel wrapper takes its plain version, so these tests pin
the plain versions the CUDA kernels are checked against on the card
(`chip_smoke.py` phases 21-25)."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.mst import dino_v3_classifier_slice as jax_dinov3
from mst_tpu.models.vit_fast import fused_mst_logits as jax_fused_mst_logits
from mst_tpu.models.vit_fast import fused_mst_saliency as jax_fused_saliency
from mst_tpu.ops import fused_block as jfb
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu_torch import predict, serve
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import (
    DinoSliceClassifier,
    dino_v2_classifier_slice,
    dino_v3_classifier_slice,
)
from mst_tpu_torch.models import vit_fast
from mst_tpu_torch.models.vit import VisionTransformer
from mst_tpu_torch.models.vit_fast import fused_mst_logits, fused_mst_saliency
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step
from mst_tpu_torch.utils.checkpoint import load_hparams

TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_fused_block.py:176 (f32)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_fused_block.py:452
PROB_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_fused_block.py:470
SAL_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_fused_block.py:472
GATED = dict(model_size="tiny128", ffn_layer="swiglu", patch_size=14,
             fusion_heads=4)  # E = 128, 2 heads, F = 344 by the 2/3 rule
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


def _mask(b, d):
    m = np.zeros((b, d), bool)
    m[0, -2:] = True  # the first volume's last two slices are padding
    return m


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


# -- the SwiGLU sub-layer -----------------------------------------------------


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("hidden", [344, 256])
def test_swiglu_sublayer_matches_mst_tpu(hidden, with_ls, eps):
    """[4, 37, 128] with F = 344 (the 2/3 rule at E = 128) and F = 256, vs
    the Pallas kernel (interpret mode) and the XLA reference; in f32 the
    kernel's gate on the f32 h12 and the reference's on h12 agree."""
    n, s, e = 4, 37, 128
    rng = np.random.default_rng(hidden + 2 * with_ls)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x = r(n, s, e)
    args = (r(e, scale=0.1, off=1.0), r(e, scale=0.1),
            r(e, 2 * hidden, scale=e ** -0.5), r(2 * hidden, scale=0.1),
            r(hidden, e, scale=hidden ** -0.5), r(e, scale=0.1),
            r(e, scale=0.1, off=1.0) if with_ls else None)
    tfb.reset_launch_counts()
    out = tfb.fused_swiglu_sublayer(_t(x), *map(_t, args), eps)
    _no_launches()
    assert out.shape == (n, s, e) and out.dtype == torch.float32
    ref = jfb.fused_swiglu_sublayer(_j(x), *map(_j, args), eps)
    xla = jfb._swiglu_ref(_j(x), *map(_j, args), eps=eps)
    _close(out, ref, what="vs the Pallas kernel")
    _close(out, xla, what="vs _swiglu_ref")
    # the first half alone: the gated product g the kernel writes
    g = tfb.ln_gemm_swiglu(_t(x).reshape(-1, e), *map(_t, args[:4]), eps)
    h = jfb._ln(_j(x), _j(args[0]), _j(args[1]), eps).reshape(-1, e)
    h1, h2 = jnp.split(h @ _j(args[2]) + _j(args[3]), 2, axis=-1)
    _close(g, jax.nn.silu(h1) * h2, what="g")


def test_swiglu_train_sublayer_and_unported_widths_raise():
    """The SwiGLU train sub-layer runs (queue B row 6 is ported): its
    forward equals the serving sub-layer's in f32 (in f32 the gate of the
    rounded h12 is the gate of h12). The FFN width rule and its override
    hold, and an unknown FFN raises."""
    rng = np.random.default_rng(12)
    x, w12, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 3, 64), (64, 256), (128, 64)))
    vec = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(
        np.float32))
    b12 = torch.zeros(256)
    tfb.reset_launch_counts()
    y = tfb.fused_swiglu_sublayer_train(x, vec, vec, w12, b12, w3, vec, None)
    _no_launches()
    assert y.shape == (1, 3, 64) and bool(torch.isfinite(y).all())
    _close(y.numpy(), tfb.fused_swiglu_sublayer(x, vec, vec, w12, b12, w3,
                                                vec, None).numpy())
    # the FFN width rule (mst_tpu/models/layers.py:82-83) and its override
    for e, kw, want in ((1536, {}, 4096), (128, {}, 344),
                        (128, dict(ffn_hidden=256), 256)):
        with torch.device("meta"):
            vit = VisionTransformer(embed_dim=e, depth=1, num_heads=2,
                                    ffn_layer="swiglu", **kw)
        assert tuple(vit.blocks_0.mlp.w3.kernel.shape) == (want, e)
        assert tuple(vit.blocks_0.mlp.w12.kernel.shape) == (e, 2 * want)
    with pytest.raises(ValueError, match="ffn_layer"):
        VisionTransformer(embed_dim=32, depth=1, num_heads=2, ffn_layer="moe")


# -- the whole model ------------------------------------------------------------


def _pair(shape, seed=0, mask=None, v3=False, **kw):
    """(jax model, flat flax params from a flax `init` with O(1)
    LayerScale, port model with the same weights, volume, targets)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = (jax_dinov3 if v3 else JaxMST)(out_ch=2, use_flash=False, **kw)
    init_m = None if mask is None else jnp.asarray(mask[:, :2])
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2]),
                     init_m)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    build = dino_v3_classifier_slice if v3 else DinoSliceClassifier
    tm = params_from_flax(build(out_ch=2, **kw), flat)
    return jm, flat, tm, x, np.arange(shape[0]) % 2


@pytest.mark.parametrize("with_mask", [False, True])
def test_gated_model_logits_match_mst_tpu_and_flax(with_mask):
    shape = (2, 1, 4, 28, 28)
    mask = _mask(2, 4) if with_mask else None
    jm, flat, tm, x, _ = _pair(shape, mask=mask, **GATED)
    assert tuple(tm.encoder.blocks_1.mlp.w3.kernel.shape) == (344, 128)
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


@pytest.mark.parametrize("plane_mode", MODES)
def test_gated_model_saliency_matches_mst_tpu(plane_mode):
    """`fused_mst_saliency` of the SwiGLU model in each plane mode vs the
    JAX `fused_mst_saliency` (Pallas kernels in interpret mode), with a
    padding mask: the blocks run the SwiGLU sub-layer in every mode, the
    CLS-only last block its plain SwiGLU."""
    shape = (2, 1, 4, 28, 28)
    mask = _mask(2, 4)
    jm, flat, tm, x, _ = _pair(shape, seed=2, **GATED)
    ref_p, ref_s = jax_fused_saliency(_tree(flat), jnp.asarray(x), jm,
                                      _j(mask), dtype=jnp.float32,
                                      plane_mode=plane_mode)
    tfb.reset_launch_counts()
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(x), _t(mask),
                                        plane_mode=plane_mode)
    _no_launches()
    assert tuple(sal.shape) == (2, 4, 28, 28)
    _close(probs.numpy(), ref_p, PROB_TOL)
    _close(sal.numpy(), ref_s, SAL_TOL)
    assert float(sal[0, -2:].abs().max()) < 1e-12


def test_gated_dinov3_logits_match_mst_tpu():
    """A gated-MLP DINOv3 (SwiGLU with a pinned width, 2D RoPE, 4
    registers) vs the JAX fused forward and flax."""
    kw = dict(model_size="tiny128", ffn_layer="swiglu", ffn_hidden=256,
              fusion_heads=4)
    shape = (2, 1, 3, 32, 32)
    mask = _mask(2, 3)
    jm, flat, tm, x, _ = _pair(shape, seed=3, v3=True, **kw)
    assert tuple(tm.encoder.blocks_0.mlp.w12.kernel.shape) == (128, 512)
    assert tm.num_register_tokens == 4 and tm.config["ffn_hidden"] == 256
    ref_fused = jax_fused_mst_logits(_tree(flat), jnp.asarray(x), jm,
                                     src_key_padding_mask=_j(mask),
                                     dtype=jnp.float32)
    ref_flax = jm.apply({"params": _tree(flat)}, jnp.asarray(x), _j(mask))
    with torch.no_grad():
        out = fused_mst_logits(tm, _t(x), _t(mask)).numpy()
    _close(out, ref_fused, MODEL_TOL)
    _close(out, ref_flax, MODEL_TOL)


def test_giant2_tree_on_meta_matches_flax_init_shapes():
    """The full giant2 classifier built on the `meta` device (nothing is
    allocated): its names and shapes are those of `jax.eval_shape` of the
    flax `init` (E 1536, 40 blocks, w12 [1536, 8192], w3 [4096, 1536],
    ~1.15 B parameters), and `random_flax_params` would draw that tree."""
    with torch.device("meta"):
        tm = dino_v2_classifier_slice(model_size="giant2")
    assert all(p.is_meta for p in tm.parameters())
    assert tm.ffn_layer == "swiglu" and tm.config["ffn_layer"] == "swiglu"
    jm = JaxMST(out_ch=2, model_size="giant2", use_flash=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 1, 28, 28)))["params"]
    want = {k: tuple(v.shape) for k, v in
            flatten_dict(shapes, sep="/").items()}
    got = {k.replace(".", "/"): tuple(p.shape)
           for k, p in tm.named_parameters()}
    assert got == want
    assert got["encoder/blocks_39/mlp/w12/kernel"] == (1536, 8192)
    assert got["encoder/blocks_39/mlp/w3/kernel"] == (4096, 1536)
    assert "encoder/blocks_40/norm1/scale" not in got
    assert 1.1e9 < sum(p.numel() for p in tm.parameters()) < 1.2e9


# -- frozen-encoder training ------------------------------------------------------


@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_frozen_adamw_steps_match_jax_make_train_step(ffn):
    """Two AdamW steps of the port's frozen train step vs the JAX
    `make_train_step` with `make_optimizer(freeze_encoder=True)` (optax
    `multi_transform` with `set_to_zero` on the encoder): every encoder
    parameter stays bit for bit what it was, every other one moves as the
    JAX one does, to 5% of lr (tests/test_torch_trainer.py)."""
    lr, wd = 1e-3, 1e-2
    kw = dict(GATED, freeze=True, ffn_layer=ffn)
    shape = (2, 1, 3, 28, 28)
    jm, flat, tm, x, t = _pair(shape, seed=4, **kw)
    x2 = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=_tree(flat),
        tx=jax_make_optimizer(lr, wd, freeze_encoder=True),
        dropout_rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm)
    opt = make_optimizer(tm.parameters(), lr, wd)
    trainable = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trainable and not any(n.startswith("encoder.") for n in trainable)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(trainable)
    state = TrainState(tm, opt)
    step = make_train_step(state)
    tfb.reset_launch_counts()
    for xb in (x, x2):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(xb), jnp.asarray(t), None)
        loss, _ = step(torch.from_numpy(xb), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    _no_launches()
    jflat = flatten_dict(jstate.params, sep="/")
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        if name.startswith("encoder."):
            assert p.grad is None, name
            np.testing.assert_array_equal(p.detach().numpy(), flat[key],
                                          err_msg=name)
            np.testing.assert_array_equal(np.asarray(jflat[key]), flat[key],
                                          err_msg=name)
            continue
        ref = np.asarray(jflat[key]) - flat[key]
        if key.endswith("self_attn/in_proj/bias"):
            # the key third: zero grad in exact arithmetic, rounding noise
            # that Adam scales to ±lr (tests/test_torch_trainer.py:117)
            e = ours.shape[0] // 3
            assert np.abs(ours[e:2 * e]).max() <= 2 * lr * (1.0 + 1e-3), name
            ours, ref = np.delete(ours, np.s_[e:2 * e]), np.delete(
                ref, np.s_[e:2 * e])
        assert np.abs(ours).max() > 0.1 * lr, name  # it did train
        np.testing.assert_allclose(ours, ref, atol=0.05 * lr, rtol=0,
                                   err_msg=name)


def test_train_cli_frozen_run_folder_serves_and_predicts(tmp_path):
    """`python -m mst_tpu_torch.train --model_size tiny128 --freeze` through
    its build functions (a SwiGLU FFN, as giant2's): the run's hparams
    record `ffn_layer` and `freeze`, `serve.load_run_model` rebuilds the
    model that was trained with its encoder as drawn, and `predict` scores
    the run with TTA and saliency."""
    args = cli.parse_args(["--dataset", "Synthetic", "--model_size",
                           "tiny128", "--freeze", "--dtype", "float32",
                           "--max_epochs", "1", "--batch_size", "2",
                           "--num_train_samples", "4", "--lr", "1e-3"])
    assert args.model_size == "tiny128" and args.freeze
    model = get_model(args.model, model_size=args.model_size, fusion_heads=4,
                      ffn_layer="swiglu", **cli.model_kwargs(args))
    assert model.freeze
    dm = cli.build_datamodule(args, "cpu", shape_cdhw=(1, 2, 28, 28),
                              num_samples=4)
    run = tmp_path / "Synthetic" / "DinoV2ClassifierSlice_run"
    trainer = cli.build_trainer(args, dm, run_dir=run)
    tfb.reset_launch_counts()
    cli.train(args, model, dm, trainer)
    _no_launches()
    hp = load_hparams(run)
    assert hp["freeze"] is True and hp["ffn_layer"] == "swiglu"
    assert hp["model_size"] == "tiny128" and hp["dataset"] == "Synthetic"
    drawn = random_flax_params(model, args.seed)
    served = serve.load_run_model(run).eval()
    assert served.config == model.config and served.freeze
    for name, p in served.named_parameters():
        key = name.replace(".", "/")
        if name.startswith("encoder."):
            np.testing.assert_array_equal(p.detach().numpy(), drawn[key],
                                          err_msg=name)
    assert not np.array_equal(served.head.kernel.detach().numpy(),
                              drawn["head/kernel"])
    vol = _t(np.random.default_rng(6).standard_normal(
        (2, 1, 2, 28, 28)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused_mst_logits(served, vol),
                                   fused_mst_logits(model, vol),
                                   atol=0, rtol=0)
    out = tmp_path / "out"
    argv = ["--run_folder", str(run), "--output_dir", str(out), "--dtype",
            "float32", "--use_tta", "--use_rollout", "--save_saliency"]
    predict.main(argv, device="cpu", shape_cdhw=(1, 2, 28, 28),
                 num_samples=2)
    with (out / "results.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    for r in rows:
        assert (out / f"case_{r['uid']}" / "saliency.nii.gz").exists()
        assert 0.0 <= float(r["NN_pred"]) <= 1.0


# -- what the card's train kernels take ---------------------------------------------


def test_encoder_train_guard_is_a_function_of_the_config(monkeypatch):
    """`check_trainable` refuses on a CUDA device, naming what is missing
    and ROADMAP queue A #12, an unfrozen encoder whose widths the train
    kernels do not take: E % 128 != 0 (the LN pullback), a head dim other
    than 64, an FFN width % 128 != 0 (the 2/3 rule's 344 at E = 128).
    Every DINOv2 size trains unfrozen on both devices (ViT-S/B/L, giant2
    with its SwiGLU FFN); the CPU path trains any width; a frozen encoder
    trains at any size and width."""
    with torch.device("meta"):
        build = dict(
            small=dino_v2_classifier_slice(),
            base=dino_v2_classifier_slice(model_size="base"),
            large=dino_v2_classifier_slice(model_size="large", remat=True,
                                           fusion_heads=16),
            giant2=dino_v2_classifier_slice(model_size="giant2", remat=True),
            giant2_frozen=dino_v2_classifier_slice(model_size="giant2",
                                                   freeze=True),
            base_frozen=dino_v2_classifier_slice(model_size="base",
                                                 freeze=True),
            tiny128=dino_v2_classifier_slice(model_size="tiny128",
                                             fusion_heads=4),
            tiny=dino_v2_classifier_slice(model_size="tiny", fusion_heads=4),
            tiny_frozen=dino_v2_classifier_slice(model_size="tiny",
                                                 fusion_heads=4, freeze=True),
            gated=DinoSliceClassifier(**GATED))
    for name in ("small", "base", "large", "giant2", "giant2_frozen",
                 "base_frozen", "tiny128", "tiny_frozen"):
        for device in ("cuda", "cpu"):
            build[name].check_trainable(device)
    for name, what in (("tiny", r"embed_dim % 128 == 0.*head dim of 64"),
                       ("gated", r"FFN width % 128 == 0")):
        build[name].check_trainable("cpu")
        with pytest.raises(NotImplementedError,
                           match=rf"{what}.*queue A #12.*freeze"):
            build[name].check_trainable(torch.device("cuda"))
    # the train step refuses at its forward's entry, before any work, with
    # the device's answer (here the card's, for a CPU batch)
    m = DinoSliceClassifier(**GATED)
    seen = []

    def as_on_the_card(device):
        seen.append(torch.device(device).type)
        DinoSliceClassifier.check_trainable(m, "cuda")

    def no_work(*a, **k):
        raise AssertionError("forward work before the refusal")

    monkeypatch.setattr(m, "check_trainable", as_on_the_card)
    monkeypatch.setattr(vit_fast, "prepare_vit_tokens", no_work)
    step = make_train_step(TrainState(m, make_optimizer(m.parameters())))
    tfb.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="queue A #12"):
        step(torch.zeros(1, 1, 1, 28, 28), torch.zeros(1, dtype=torch.long))
    _no_launches()
    with pytest.raises(NotImplementedError, match="queue A #12"):
        fused_mst_logits(m, torch.zeros(1, 1, 1, 28, 28), train=True)
    assert seen == ["cpu", "cpu"]
