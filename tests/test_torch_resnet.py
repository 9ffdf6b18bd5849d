"""The port's ResNet family (`mst_tpu_torch/models/resnet.py`, Grad-CAM++,
the ResNets' saliency, train step, checkpoints and converters) on the CPU
against `mst_tpu`, in f32 on the same weights and inputs (numpy seeds):

- `ResNetBackbone` 2D and 3D (variant 18), with the running statistics
  and with batch statistics, `ResNet3DClassifier` and `ResNetSliceTrans`
  (variant 18, and 50 once; with a key-padding mask, with and without
  LiRE) vs flax: within 1e-4;
- the BatchNorm statistics one train step leaves vs flax's
  `mutable=["batch_stats"]`: within 1e-5; the parameters after the AdamW
  step vs the JAX `make_train_step(has_batch_stats=True)`: within 5% of
  the learning rate;
- `grad_cam_weights` / `grad_cam_map` / `argmax_logit_gradcam` vs
  `mst_tpu.ops.gradcam`: within 1e-5; `_resnet3d_saliency` and
  `_resnet_slice_saliency` with and without TTA vs the JAX
  `make_predict_fn(batch_stats=...)`: within 1e-4;
- the ResNet converters bit for bit on seeded state dicts (torchvision 2D,
  MONAI 3D, the `module.` prefix, the reference's two ResNet models);
- checkpoints and `--resume` keep the statistics.

Sizes: [2, 1, 8, 16, 16] volumes (the 3D stem and pool leave 2 x 4 x 4;
each slice's 2D maps 4 x 4 after the pool)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models import convert as jconv
from mst_tpu.models import resnet as jr
from mst_tpu.ops import gradcam as jg
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu_torch.models import convert
from mst_tpu_torch.models import resnet as tr
from mst_tpu_torch.ops import gradcam as tg
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.train.trainer import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from mst_tpu_torch.utils.checkpoint import (
    load_best_batch_stats,
    restore_train_state,
    save_best_checkpoint,
    save_checkpoint,
    save_train_state,
)

SHAPE = (2, 1, 8, 16, 16)
TOL = 1e-4  # forwards, f32
STATS_TOL = 1e-5
CAM_TOL = 1e-5
SAL_TOL = 1e-4


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _varied(flat_params, flat_stats, rng):
    """BN scale / bias and running statistics away from their init, so
    that every one of them shapes the output."""
    params = dict(flat_params)
    for k, v in params.items():
        if k.endswith("/scale"):
            params[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k.endswith("/bias") and ("/bn" in k or "_bn/" in k):
            params[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    stats = {k: ((0.1 * rng.standard_normal(v.shape)) if k.endswith("/mean")
                 else (1.0 + 0.3 * np.abs(rng.standard_normal(v.shape)))
                 ).astype(np.float32) for k, v in flat_stats.items()}
    return params, stats


def _pair(kind, variant=18, seed=0, shape=SHAPE, **kw):
    """(flax model, variables, port model with the same weights, volume)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "3d":
        jm = jr.ResNet3DClassifier(variant=variant)
        tm = tr.ResNet3DClassifier(variant=variant)
    else:
        jm = jr.ResNetSliceTrans(variant=variant, **kw)
        tm = tr.ResNetSliceTrans(variant=variant, **kw)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params, stats = _varied(_flat(v["params"]), _flat(v["batch_stats"]), rng)
    convert.params_from_flax(tm, params, stats)
    return jm, {"params": _tree(params), "batch_stats": _tree(stats)}, tm, x


def _mask():
    m = np.zeros((SHAPE[0], SHAPE[2]), bool)
    m[1, 5:] = True
    return m


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=tol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("train", [False, True])
def test_backbone_matches_flax(dims, train):
    rng = np.random.default_rng(dims)
    in_ch = 3 if dims == 2 else 1
    # enough samples a channel in the last stage (a 1 x 1 map there) that
    # the batch variance is not a difference of near-equal f32 sums
    shape = (16, in_ch, 16, 16) if dims == 2 else (16, in_ch, 8, 16, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    jm = jr.ResNetBackbone(variant=18)
    v = jm.init(jax.random.PRNGKey(dims), xj)
    params, stats = _varied(_flat(v["params"]), _flat(v["batch_stats"]), rng)
    tm = tr.ResNetBackbone(18, dims=dims, in_ch=in_ch)
    convert.params_from_flax(tm, params, stats)
    variables = {"params": _tree(params), "batch_stats": _tree(stats)}
    if train:
        ref, upd = jm.apply(variables, xj, train=True,
                            mutable=["batch_stats"])
        _close(convert.flax_batch_stats_from_torch(tm)["bn1/mean"],
               stats["bn1/mean"], 0.0)  # nothing moves before the forward
    else:
        ref = jm.apply(variables, xj)
    ours = tm(torch.from_numpy(x), train=train)
    _close(ours.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1), TOL)
    if train:
        got = convert.flax_batch_stats_from_torch(tm)
        want = _flat(upd["batch_stats"])
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], STATS_TOL, k)


@pytest.mark.parametrize("kind,variant,kw", [
    ("3d", 18, {}), ("3d", 50, {}), ("slice", 18, {}),
    ("slice", 18, {"rotary": "LiRE"}), ("slice", 18, {"rotary": "RoPE"}),
])
@pytest.mark.parametrize("masked", [False, True])
def test_classifier_logits_match_flax(kind, variant, kw, masked):
    jm, variables, tm, x = _pair(kind, variant, **kw)
    mask = _mask() if masked else None
    ref = jm.apply(variables, jnp.asarray(x),
                   None if mask is None else jnp.asarray(mask))
    ours = tm(torch.from_numpy(x), None if mask is None
              else torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 2)
    _close(ours.detach().numpy(), ref, TOL)


@pytest.mark.parametrize("kind", ["3d", "slice"])
def test_train_step_batch_stats_and_adamw_match_jax(kind):
    """One step of the port's train step vs the JAX `make_train_step` with
    batch statistics (the flax path): the loss, the running statistics it
    leaves (flax `mutable=["batch_stats"]`), and every parameter's AdamW
    move within 5% of lr (the port's convention, tests/test_torch_trainer.py),
    then the eval step on the moved statistics.

    Adam's first move is lr * g / (|g| + eps): a grad near 0 moves by about
    lr in the direction of its sign, which f32 rounding decides. Through
    train-mode BatchNorm the JAX package's f32 grads of the 3D model's
    early stages lie up to 5% of their largest magnitude from the same
    grads in f64 (the port's f32 grads within 1e-4 of its f64 ones,
    checked here), so there a move may flip sign: such an element must be
    an Adam step on both sides, its grad within `near_zero` of the largest,
    and at most `flip_frac` of the parameter's elements (bar the key third
    of the fusion's in_proj bias, whose grad is 0 in exact arithmetic, so
    all noise). The 3D volumes are [2, 1, 16, 64, 64], so that each channel of
    the last stage normalises 8 values."""
    lr, wd = 1e-3, 1e-2
    near_zero, flip_frac = 0.05, 0.005
    shape = (2, 1, 16, 64, 64) if kind == "3d" else SHAPE
    jm, variables, tm, x = _pair(kind, seed=3, shape=shape)
    t = np.array([0, 1])
    p0 = _flat(variables["params"])
    # the port's grads in f64 at the same weights (a copy: its statistics
    # move too)
    m64 = copy.deepcopy(tm).double()
    F.cross_entropy(m64(torch.from_numpy(x).double(), train=True,
                        dtype=torch.float64), torch.from_numpy(t)).backward()
    g64 = {n.replace(".", "/"): q.grad.numpy()
           for n, q in m64.named_parameters()}
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        tx=jax_make_optimizer(lr, wd), dropout_rng=jax.random.PRNGKey(0),
        batch_stats=variables["batch_stats"])
    jstate, jloss, _ = jax_make_train_step(jm, has_batch_stats=True)(
        jstate, jnp.asarray(x), jnp.asarray(t), None)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, wd))
    loss, _ = make_train_step(state)(torch.from_numpy(x), torch.from_numpy(t))
    _close(float(loss), float(jloss), 1e-5, "loss")
    got = convert.flax_batch_stats_from_torch(tm)
    want = _flat(jstate.batch_stats)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, STATS_TOL, k)
    jflat = _flat(jstate.params)
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        scale = np.abs(g64[key]).max()
        _close(p.grad.numpy(), g64[key], 1e-4 * scale, f"{key} grad")
        ours, ref = p.detach().numpy() - p0[key], jflat[key] - p0[key]
        flip = np.abs(ours - ref) > 0.05 * lr
        adam = lr * (1.0 + wd * np.abs(p0[key][flip])) + 1e-9
        assert (np.abs(ours[flip]) <= adam).all(), key
        assert (np.abs(ref[flip]) <= adam).all(), key
        assert (np.abs(g64[key][flip]) <= near_zero * scale).all(), key
        if key.endswith("self_attn/in_proj/bias"):
            e = flip.shape[0] // 3  # [q | k | v]: the k third is all noise
            flip = np.delete(flip, np.s_[e:2 * e])
        assert flip.mean() <= flip_frac, (key, flip.mean())
    # the eval step normalises by the running statistics: JAX's state
    # after its step, through the port
    convert.params_from_flax(tm, jflat, want)
    ref = jm.apply({"params": jstate.params,
                    "batch_stats": jstate.batch_stats}, jnp.asarray(x))
    _close(make_eval_step(tm)(torch.from_numpy(x)).numpy(), ref, TOL)


@pytest.mark.parametrize("mode", ["gradcam", "gradcam++"])
@pytest.mark.parametrize("spatial", [(3, 4), (2, 3, 4)])
def test_grad_cam_weights_and_map_match_mst_tpu(mode, spatial):
    rng = np.random.default_rng(len(spatial))
    shape = (3, 5, *spatial)
    act = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    grads = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    ta, tgr = torch.from_numpy(act), torch.from_numpy(grads)
    _close(tg.grad_cam_weights(tgr, ta, mode),
           jg.grad_cam_weights(jnp.asarray(grads), jnp.asarray(act), mode),
           CAM_TOL)
    _close(tg.grad_cam_map(ta, tgr, mode),
           jg.grad_cam_map(jnp.asarray(act), jnp.asarray(grads), mode),
           CAM_TOL)
    with pytest.raises(ValueError, match="CAM mode"):
        tg.grad_cam_weights(tgr, ta, "cam")


def test_argmax_logit_gradcam_matches_mst_tpu():
    jm, variables, tm, x = _pair("3d", seed=5)
    jl, jcam = jg.argmax_logit_gradcam(
        lambda a: jm.apply(variables, a, method="features"),
        lambda a: jm.apply(variables, a, method="classify"), jnp.asarray(x))
    tl, tcam = tg.argmax_logit_gradcam(tm.features, tm.classify,
                                       torch.from_numpy(x))
    _close(tl, jl, TOL)
    _close(tcam, jcam, CAM_TOL)


@pytest.mark.parametrize("kind,kw", [("3d", {}), ("slice", {}),
                                     ("slice", {"rotary": "LiRE"})])
@pytest.mark.parametrize("tta", [False, True])
def test_resnet_saliency_matches_jax_predict_fn(kind, kw, tta):
    jm, variables, tm, x = _pair(kind, seed=6, **kw)
    mask = _mask() if kind == "slice" else None
    jfn = jax_make_predict_fn(jm, tta=tta,
                              batch_stats=variables["batch_stats"])
    jprobs, jsal = jfn(variables["params"], jnp.asarray(x),
                       None if mask is None else jnp.asarray(mask))
    probs, sal = make_predict_fn(tm, tta=tta)(x, mask)
    assert tuple(sal.shape) == (2, 8, 16, 16)
    _close(probs, jprobs, SAL_TOL)
    _close(sal, jsal, SAL_TOL)
    # the plain forward (no saliency) of the predictor
    jp, _ = jax_make_predict_fn(jm, tta=tta, with_saliency=False,
                                batch_stats=variables["batch_stats"])(
        variables["params"], jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))
    tp, none = make_predict_fn(tm, tta=tta, with_saliency=False)(x, mask)
    assert none is None
    _close(tp, jp, SAL_TOL)


def _torch_resnet_sd(variant, dims, seed, prefix=""):
    """A seeded torchvision (2D) / MONAI (3D) resnet state dict with the
    torch names and layouts: the port backbone's leaves mapped back (conv
    [out, in, *k], bn weight / bias / running_mean / running_var,
    num_batches_tracked, an fc head)."""
    rng = np.random.default_rng(seed)
    bb = tr.ResNetBackbone(variant, dims=dims, in_ch=3 if dims == 2 else 1)
    sd = {}

    def tname(name):
        parts = name.split(".")
        out = []
        for p in parts:
            if p.startswith("layer") and "_" in p:
                out += p.split("_")
            elif p == "downsample_conv":
                out += ["downsample", "0"]
            elif p == "downsample_bn":
                out += ["downsample", "1"]
            else:
                out.append(p)
        return ".".join(out)

    for name, p in bb.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        shape = tuple(p.shape)
        if leaf == "kernel":
            k = len(shape) - 2
            shape = (shape[-1], shape[-2], *shape[:k])
            sd[f"{tname(mod)}.weight"] = rng.standard_normal(shape).astype(
                np.float32)
        else:
            sd[f"{tname(mod)}.{'weight' if leaf == 'scale' else 'bias'}"] = \
                rng.standard_normal(shape).astype(np.float32)
    for name, _ in tr.batchnorms(bb):
        c = getattr(bb.get_submodule(name), "mean").shape
        sd[f"{tname(name)}.running_mean"] = rng.standard_normal(c).astype(
            np.float32)
        sd[f"{tname(name)}.running_var"] = rng.random(c).astype(np.float32)
        sd[f"{tname(name)}.num_batches_tracked"] = np.array(7)
    out_ch = tr.resnet_out_channels(variant)
    sd["fc.weight"] = rng.standard_normal((3, out_ch)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(3).astype(np.float32)
    return {f"{prefix}{k}": v for k, v in sd.items()}


def _same(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(
            ours[k], ref[k]), k


@pytest.mark.parametrize("variant,dims,prefix", [
    (18, 2, ""),  # torchvision 2D
    (50, 3, ""),  # MONAI 3D
    (34, 2, "module."),  # MedicalNet's DataParallel prefix
])
def test_convert_torch_resnet_bit_for_bit(variant, dims, prefix):
    sd = _torch_resnet_sd(variant, dims, seed=variant, prefix=prefix)
    jp, js = jconv.convert_torch_resnet(sd, variant)
    tp, ts = convert.convert_torch_resnet(sd, variant)
    _same(tp, _flat(jp))
    _same(ts, _flat(js))
    # and the flat dicts load into the port backbone
    bb = tr.ResNetBackbone(variant, dims=dims, in_ch=3 if dims == 2 else 1)
    convert.params_from_flax(bb, tp, ts)


def test_convert_reference_resnets_bit_for_bit():
    sd3 = {f"model.{k}": v for k, v in _torch_resnet_sd(18, 3, 1).items()}
    jp, js = jconv.convert_reference_resnet3d(sd3, 18)
    tp, ts = convert.convert_reference_resnet3d(sd3, 18)
    _same(tp, _flat(jp))
    _same(ts, _flat(js))
    sd2 = {f"model.{k}": v for k, v in _torch_resnet_sd(18, 2, 2).items()}
    rng = np.random.default_rng(3)
    e = 512
    for k, shape in (("cls_token", (1, 1, e)), ("linear.weight", (2, e)),
                     ("linear.bias", (2,)), ("slice_fusion.norm.weight", (e,)),
                     ("slice_fusion.norm.bias", (e,))):
        sd2[k] = rng.standard_normal(shape).astype(np.float32)
    p = "slice_fusion.layers.0"
    for k, shape in (("self_attn.in_proj_weight", (3 * e, e)),
                     ("self_attn.in_proj_bias", (3 * e,)),
                     ("self_attn.out_proj.weight", (e, e)),
                     ("self_attn.out_proj.bias", (e,)),
                     ("linear1.weight", (e, e)), ("linear1.bias", (e,)),
                     ("linear2.weight", (e, e)), ("linear2.bias", (e,)),
                     ("norm1.weight", (e,)), ("norm1.bias", (e,)),
                     ("norm2.weight", (e,)), ("norm2.bias", (e,))):
        sd2[f"{p}.{k}"] = rng.standard_normal(shape).astype(np.float32)
    jp, js = jconv.convert_reference_resnet_slice(sd2, 18)
    tp, ts = convert.convert_reference_resnet_slice(sd2, 18)
    _same(tp, _flat(jp))
    _same(ts, _flat(js))
    convert.params_from_flax(tr.ResNetSliceTrans(variant=18), tp, ts)


def test_registry_builds_the_reference_variants():
    r = get_model("ResNet", model_size="small", fusion_heads=12, rotary=None)
    assert isinstance(r, tr.ResNet3DClassifier) and r.variant == 50
    s = get_model("ResNetSliceTrans", freeze=True)
    assert isinstance(s, tr.ResNetSliceTrans) and s.variant == 34
    assert s.fusion_0.self_attn.num_heads == 16 and s.emb_ch == 512
    # the flax trees of the reference variants, leaf for leaf
    x = jnp.zeros((1, 1, 2, 32, 32), jnp.float32)
    for model, jmodel in ((r, jr.ResNet3DClassifier(variant=50)),
                          (s, jr.ResNetSliceTrans(variant=34))):
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
        want = {k: tuple(v.shape) for k, v in
                flatten_dict(shapes["params"], sep="/").items()}
        got = {n.replace(".", "/"): tuple(p.shape)
               for n, p in model.named_parameters()}
        assert got == want
        assert set(convert.flax_batch_stats_from_torch(model)) == set(
            flatten_dict(shapes["batch_stats"], sep="/"))


def test_checkpoints_and_resume_keep_batch_stats(tmp_path):
    _, variables, tm, x = _pair("slice", seed=7)
    stats = convert.flax_batch_stats_from_torch(tm)
    save_checkpoint(tmp_path, "epoch=0", tm, hparams={"model": "x"})
    save_best_checkpoint(tmp_path, "epoch=0")
    got = load_best_batch_stats(tmp_path)
    _same(got, stats)
    state = TrainState(tm, make_optimizer(tm.parameters(), 1e-3))
    make_train_step(state)(torch.from_numpy(x), torch.tensor([0, 1]))
    moved = convert.flax_batch_stats_from_torch(tm)
    save_train_state(tmp_path, "last", state, meta={"epoch": 0})
    other = tr.ResNetSliceTrans(variant=18)
    back, _ = restore_train_state(tmp_path, "last", TrainState(
        other, make_optimizer(other.parameters(), 1e-3)))
    _same(convert.flax_batch_stats_from_torch(other), moved)
    for a, b in zip(tm.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert back.step == 1
