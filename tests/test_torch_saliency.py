"""The port's explainability path on CPU tensors against `mst_tpu`, in f32
on the same numpy inputs:

- the saliency sub-layers (`fused_attention_sublayer_with_row`, `_rollout`,
  `_abnar`) against the Pallas kernels in interpret mode;
- every `ops/saliency.py` function against its JAX twin;
- `fused_mst_saliency` in each plane mode against the JAX flax
  explainability path (`_forward_with_saliency(force_flax=True)`), and TTA
  with saliency against the JAX `make_predict_fn`;
- `python -m mst_tpu_torch.predict` and `serve --run_folder` on a tiny run
  folder written by the port's own `Trainer`, and the NIfTI and metric
  helpers they use.

On the CPU every kernel wrapper takes its plain version, so these tests pin
the plain versions the CUDA kernels are checked against on the card
(`chip_smoke.py`)."""

import csv
import gzip

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.ops import fused_block as jfb
from mst_tpu.ops import saliency as jsal
from mst_tpu.train.predictor import _forward_with_saliency
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu.utils import metrics as jmetrics
from mst_tpu.utils.nifti import read_nifti
from mst_tpu.utils.nifti import write_nifti as jax_write_nifti
from mst_tpu_torch import predict, serve
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import (
    FastViTConfig,
    fused_mst_saliency,
    fused_vit_cls,
)
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import saliency as tsal
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.train.trainer import Trainer
from mst_tpu_torch.utils import metrics as tmetrics
from mst_tpu_torch.utils.checkpoint import BEST_POINTER
from mst_tpu_torch.utils.nifti import write_nifti

matplotlib.use("Agg")

N, S, E, HEADS = 2, 9, 32, 4
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)
PROB_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_fused_block.py:470
SAL_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_fused_block.py:472
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
MODES = ("last", "rollout", "rollout_abnar")


def _no_launches():
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch
    assert set(tfb.sublayer_calls().values()) == {0}


# -- the three sub-layers against the Pallas kernels (interpret mode) ------


def _attn_inputs(seed, with_ls):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x = r(N, S, E)
    args = (r(E, scale=0.1, off=1.0), r(E, scale=0.1), r(E, 3 * E, scale=0.3),
            r(3 * E, scale=0.1), r(E, E, scale=0.1), r(E, scale=0.1),
            r(E, scale=0.1, off=1.0) if with_ls else None)
    # a carry that is not one-hot: positive, as a rollout row is
    carry = rng.uniform(0.0, 1.0, (N, HEADS, S)).astype(np.float32)
    return x, args, carry


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_outputs(out, ref, tol=TOL):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("with_ls", [False, True])
def test_with_row_sublayer_matches_mst_tpu(with_ls):
    x, args, _ = _attn_inputs(0, with_ls)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer_with_row(_t(x), *map(_t, args), HEADS)
    ref = jfb.fused_attention_sublayer_with_row(_j(x), *map(_j, args), HEADS)
    _assert_outputs(out, ref)
    # the row is a softmax row of each head
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-6)
    _no_launches()


@pytest.mark.parametrize("want_row", [False, True])
@pytest.mark.parametrize("with_ls", [False, True])
def test_rollout_sublayer_matches_mst_tpu(with_ls, want_row):
    x, args, carry = _attn_inputs(1, with_ls)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer_rollout(
        _t(x), *map(_t, args), _t(carry), HEADS, 1e-6, want_row=want_row)
    ref = jfb.fused_attention_sublayer_rollout(
        _j(x), *map(_j, args), _j(carry), HEADS, 1e-6, want_row=want_row)
    _assert_outputs(out, ref)
    # the carry's mass is kept: each softmax row sums to 1
    np.testing.assert_allclose(out[-1].sum(-1).numpy(), carry.sum(-1),
                               rtol=1e-5)
    _no_launches()


@pytest.mark.parametrize("with_ls", [False, True])
def test_abnar_sublayer_matches_mst_tpu(with_ls):
    x, args, _ = _attn_inputs(2, with_ls)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer_abnar(_t(x), *map(_t, args), HEADS)
    ref = jfb.fused_attention_sublayer_abnar(_j(x), *map(_j, args), HEADS)
    _assert_outputs(out, ref)
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-6)
    _no_launches()


def test_saliency_sublayers_refuse_rope():
    """The saliency sub-layers take RoPE (DINOv3) as both tables or none:
    half a table is refused."""
    x, args, carry = _attn_inputs(3, True)
    cos = torch.ones(S, E // HEADS)
    with pytest.raises(ValueError, match="rope_cos and rope_sin"):
        tfb.fused_attention_sublayer_abnar(_t(x), *map(_t, args), HEADS,
                                           rope_cos=cos)
    with pytest.raises(ValueError, match="rope_cos and rope_sin"):
        tfb.fused_attention_sublayer_rollout(_t(x), *map(_t, args),
                                             _t(carry), HEADS, rope_sin=cos)
    # cos = 1, sin = 0 is the identity rotation
    zero = torch.zeros(S, E // HEADS)
    _assert_outputs(
        tfb.fused_attention_sublayer_abnar(_t(x), *map(_t, args), HEADS,
                                           rope_cos=cos, rope_sin=zero),
        tfb.fused_attention_sublayer_abnar(_t(x), *map(_t, args), HEADS))


# -- ops/saliency.py against mst_tpu/ops/saliency.py -----------------------


def _probs(rng, *shape):
    """Softmax rows [..., T] f32."""
    p = np.exp(rng.standard_normal(shape))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _saliency_case(name, rng):
    """(port fn, jax fn, numpy args, static args) of one saliency function."""
    layers3 = [_probs(rng, 3, HEADS, 10, 10) for _ in range(3)]
    cases = {
        "slice_attention": ((_probs(rng, 2, HEADS, 5, 5),), ()),
        "plane_attention": ((_probs(rng, 6, HEADS, 10, 10),), (1, (3, 3))),
        "plane_attention_from_row": ((_probs(rng, 6, HEADS, 11),),
                                     (2, (3, 3))),
        "combined_saliency": ((rng.random((2, 3)).astype(np.float32),
                               rng.random((6, 4, 5)).astype(np.float32)), ()),
        "attention_cls_rollout": ((layers3,), ()),
        "attention_rollout": ((layers3, 1), ()),
        "attention_rollout_from_factors": (([_probs(rng, 3, 10, 10)
                                             for _ in range(3)], 1), ()),
        "upsample_saliency": ((rng.random((2, 4, 16, 16)).astype(np.float32),),
                              ((4, 224, 224),)),
    }
    return (getattr(tsal, name), getattr(jsal, name), *cases[name])


def _conv(a, f):
    if isinstance(a, list):
        return [f(x) for x in a]
    return f(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", [
    "slice_attention", "plane_attention", "plane_attention_from_row",
    "combined_saliency", "attention_cls_rollout", "attention_rollout",
    "attention_rollout_from_factors", "upsample_saliency"])
def test_saliency_function_matches_mst_tpu(name):
    fn, jfn, arrays, static = _saliency_case(name, np.random.default_rng(7))
    out = fn(*[_conv(a, torch.from_numpy) for a in arrays], *static)
    ref = jfn(*[_conv(a, jnp.asarray) for a in arrays], *static)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-5)


# -- the model: fused_mst_saliency against the flax explainability path ----


def _models(seed=0, **kw):
    """(port model, jax model, jax params) on the same seeded weights with
    O(1) LayerScale, so that every block counts."""
    kw = dict(TINY, **kw)
    tm = DinoSliceClassifier(out_ch=2, **kw)
    flat = random_flax_params(tm, seed)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    params_from_flax(tm, flat)
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})
    return tm, JaxMST(out_ch=2, use_flash=False, **kw), jparams


def _volumes(seed=1, b=2, d=4):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal((b, 1, d, 28, 28)).astype(np.float32)
    mask = np.zeros((b, d), bool)
    mask[0, -2:] = True  # the first volume's last two slices are padding
    return vols, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("plane_mode", MODES)
def test_fused_mst_saliency_matches_flax_path(plane_mode, with_mask):
    tm, jm, jparams = _models(num_register_tokens=2)
    vols, mask = _volumes()
    mask = mask if with_mask else None
    probs_ref, sal_ref = _forward_with_saliency(
        jm, {"params": jparams}, jnp.asarray(vols), _j(mask),
        plane_mode=plane_mode, force_flax=True)
    tfb.reset_launch_counts()
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(vols), _t(mask),
                                        plane_mode=plane_mode)
    assert tuple(sal.shape) == (2, 4, 28, 28) and sal.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref),
                               **PROB_TOL)
    np.testing.assert_allclose(sal.numpy(), np.asarray(sal_ref), **SAL_TOL)
    _no_launches()
    if with_mask:  # padded slices carry no slice attention
        assert float(sal[0, -2:].abs().max()) < 1e-12


def test_no_cheap_last_row_matches_cheap_last_row(monkeypatch):
    """MST_NO_CHEAP_LAST runs block 11 in full and takes the row from the
    `with_row` sub-layer; it must give the CLS-only last block's row and
    CLS feature."""
    tm, _, _ = _models(3)
    cfg = FastViTConfig.from_model(tm)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 28, 28, 3)).astype(np.float32))
    with torch.inference_mode():
        monkeypatch.delenv("MST_NO_CHEAP_LAST", raising=False)
        cls_c, row_c = fused_vit_cls(tm.encoder, x, cfg, torch.float32,
                                     want_last_row=True)
        monkeypatch.setenv("MST_NO_CHEAP_LAST", "1")
        cls_f, row_f = fused_vit_cls(tm.encoder, x, cfg, torch.float32,
                                     want_last_row=True)
        plain = fused_vit_cls(tm.encoder, x, cfg, torch.float32)
    assert tuple(row_f.shape) == (3, cfg.num_heads, 5)
    torch.testing.assert_close(row_f, row_c, **TOL)
    torch.testing.assert_close(cls_f, cls_c, **TOL)
    torch.testing.assert_close(plain, cls_f, **TOL)


def test_saliency_modes_are_exclusive_and_serving_only():
    tm, _, _ = _models()
    cfg = FastViTConfig.from_model(tm)
    x = torch.zeros(1, 28, 28, 3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fused_vit_cls(tm.encoder, x, cfg, torch.float32, want_rollout=True,
                      want_abnar=True)
    with pytest.raises(ValueError, match="serving-only"):
        fused_vit_cls(tm.encoder, x, cfg, torch.float32, train=True,
                      want_last_row=True)
    with pytest.raises(ValueError, match="plane_mode"):
        fused_mst_saliency(tm, torch.zeros(1, 1, 2, 28, 28), plane_mode="x")


@pytest.mark.parametrize("plane_mode", ["last", "rollout"])
def test_tta_saliency_matches_mst_tpu(plane_mode):
    tm, jm, jparams = _models(5)
    vols, mask = _volumes(6, b=1)
    ref_p, ref_s = jax_make_predict_fn(jm, tta=True, with_saliency=True,
                                       plane_mode=plane_mode)(
        jparams, jnp.asarray(vols), jnp.asarray(mask))
    probs, sal = make_predict_fn(tm, tta=True, plane_mode=plane_mode)(
        vols, mask)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), **PROB_TOL)
    np.testing.assert_allclose(sal.numpy(), np.asarray(ref_s), **SAL_TOL)


# -- metrics and NIfTI -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_working_point_and_cm_metrics_match_mst_tpu(seed):
    import matplotlib.pyplot as plt

    from mst_tpu.utils.roc_curve import plot_roc_curve

    rng = np.random.default_rng(seed)
    y = (np.arange(40) % 2)[rng.permutation(40)]
    score = np.round(rng.random(40) * 0.6 + 0.3 * y, 1)  # ties included
    fig, ax = plt.subplots()
    *_, cm_ref = plot_roc_curve(y, score, ax, n_bootstrap=4)
    plt.close(fig)
    thr, cm = tmetrics.youden_working_point(y, score)
    np.testing.assert_array_equal(cm, cm_ref)
    assert np.array_equal(cm, tmetrics.confusion_matrix(score >= thr, y))
    assert tmetrics.cm2acc(cm) == jmetrics.cm2acc(cm_ref)
    np.testing.assert_array_equal(tmetrics.cm2x(cm), jmetrics.cm2x(cm_ref))
    zero = np.array([[3, 0], [2, 0]])  # no positive prediction: NaN PPV
    np.testing.assert_array_equal(tmetrics.cm2x(zero), jmetrics.cm2x(zero))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.bool_])
def test_write_nifti_matches_mst_tpu(tmp_path, dtype):
    rng = np.random.default_rng(8)
    data = (rng.standard_normal((5, 4, 3)) > 0 if dtype is np.bool_ else
            (rng.random((5, 4, 3)) * 200).astype(dtype))
    aff = np.diag([0.7, 0.8, 2.5, 1.0])
    write_nifti(tmp_path / "port.nii.gz", data, aff)
    jax_write_nifti(tmp_path / "jax.nii.gz", data, aff)
    with gzip.open(tmp_path / "port.nii.gz") as a, \
            gzip.open(tmp_path / "jax.nii.gz") as b:
        assert a.read() == b.read()
    back, back_aff = read_nifti(tmp_path / "port.nii.gz")
    np.testing.assert_array_equal(back, data.astype(back.dtype))
    np.testing.assert_allclose(back_aff, aff, atol=1e-6)


# -- the predict CLI and the server on a run folder of the port's Trainer --


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """A tiny run folder: `Trainer.fit` for one epoch on Synthetic data."""
    run = tmp_path_factory.mktemp("runs") / "Synthetic" / "DinoV2_run"
    ds = Synthetic_Dataset3D(num_samples=8, shape_cdhw=(1, 2, 28, 28))
    dm = DataModule(ds_train=ds, ds_val=ds, batch_size=4, num_train_samples=8)
    trainer = Trainer(run, max_epochs=1, patience=1)
    state = trainer.init_state(DinoSliceClassifier(out_ch=2, **TINY), 1e-3,
                               seed=0)
    trainer.fit(state, dm, hparams={"model": "DinoV2ClassifierSlice",
                                    "dataset": "Synthetic", **TINY})
    assert (run / BEST_POINTER).exists()
    return run


def test_predict_cli_writes_results_log_and_nifti(run_folder, tmp_path):
    out = tmp_path / "out"
    data_kw = dict(shape_cdhw=(1, 2, 28, 28), num_samples=4)
    argv = ["--run_folder", str(run_folder), "--output_dir", str(out),
            "--dtype", "float32", "--use_tta", "--use_rollout",
            "--save_saliency"]
    assert predict.main(argv, device="cpu", **data_kw) == out

    # the same cases through the predictor on the run's model
    model = serve.load_run_model(run_folder).eval()
    fn = make_predict_fn(model, tta=True, plane_mode="rollout")
    ds = Synthetic_Dataset3D(seed=2, **data_kw)  # the test split
    with (out / "results.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert [r["uid"] for r in rows] == [ds[i]["uid"] for i in range(4)]
    for i, r in enumerate(rows):
        # the loader ships volumes in float16 (`DataModule.wire_dtype`)
        src = ds[i]["source"].astype(np.float16).astype(np.float32)
        probs, sal = fn(src[None])
        assert int(r["GT"]) == ds[i]["target"]
        assert int(r["NN"]) == int(probs[0].argmax())
        np.testing.assert_allclose(float(r["NN_pred"]), float(probs[0, 1]),
                                   rtol=1e-6, atol=1e-7)
        case = out / f"case_{r['uid']}"
        got, aff = read_nifti(case / "saliency.nii.gz")
        np.testing.assert_allclose(got, sal[0].numpy().transpose(2, 1, 0),
                                   rtol=1e-6, atol=1e-9)
        vol, _ = read_nifti(case / "input.nii.gz")
        np.testing.assert_array_equal(vol, src[0].transpose(2, 1, 0))
        np.testing.assert_allclose(aff, np.eye(4))
    text = (out / "predict.log").read_text()
    for key in ("AUC=", "argmax ACC=", "Youden point", "PPV=", "NPV=",
                "Sens=", "Spec="):
        assert key in text, key


@pytest.mark.parametrize("flag,item", [
    (["--num_devices", "2"], "#13"), (["--distributed"], "#13")])
def test_predict_cli_refuses_unported_flags(flag, item, capsys):
    with pytest.raises(SystemExit):
        predict.parse_args(["--run_folder", "x", *flag])
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag,attr,value", [
    (["--get_attention"], "get_attention", True),
    (["--get_segmentation"], "get_segmentation", True),
    (["--ensemble", "x", "y"], "ensemble", ["x", "y"])])
def test_predict_cli_takes_the_ported_flags(flag, attr, value):
    """--get_attention, --get_segmentation and --ensemble are ported
    (tests/test_torch_predict_options.py runs them): each parses, and the
    first two turn the saliency forward on, one case per batch."""
    args = predict.parse_args(["--run_folder", "x", *flag])
    assert getattr(args, attr) == value
    assert predict.wants_saliency(args) == (attr != "ensemble")


def test_predict_cli_takes_int8_flags():
    """--int8 [--int8_calib N] is ported (tests/test_torch_int8.py runs it);
    --int8_calib alone is a usage error."""
    args = predict.parse_args(["--run_folder", "x", "--int8"])
    assert args.int8 and args.int8_calib == 0
    args = predict.parse_args(["--run_folder", "x", "--int8",
                               "--int8_calib", "4", "--use_tta",
                               "--use_rollout"])
    assert args.int8 and args.int8_calib == 4
    with pytest.raises(SystemExit):
        predict.parse_args(["--run_folder", "x", "--int8_calib", "4"])


def test_serve_cli_serves_a_run_folder(run_folder):
    """`python -m mst_tpu_torch.serve --run_folder`: the run's model with
    its best checkpoint (`load_run_model`, on the CPU here; the CLI serves
    on the card)."""
    args = serve.parse_args(["--run_folder", str(run_folder), "--dtype",
                             "float32", "--port", "0", "--batch_size", "2"])
    model = serve.load_run_model(args.run_folder, torch.float32).eval()
    assert isinstance(model, DinoSliceClassifier)
    assert model.model_size == "tiny"
    server, predictor = serve.build_server(args, model)
    try:
        vol = np.random.default_rng(9).standard_normal(
            (1, 2, 28, 28)).astype(np.float32)
        got = predictor.submit(vol, timeout=60)
        want, sal = make_predict_fn(model, with_saliency=False)(vol[None])
        assert sal is None
        np.testing.assert_allclose(got, want.numpy()[0], atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()
    with pytest.raises(FileNotFoundError, match="not a run folder"):
        serve.load_run_model(run_folder.parent)


def test_fused_mst_saliency_matches_flax_path_at_d1024_with_mask():
    """A long volume (D = 1024 > the 256-slice position table, which is
    depth-interpolated) with padded slices: the fused saliency path against
    the flax explainability path."""
    tm, jm, jparams = _models(10, use_slice_pos_emb=True)
    rng = np.random.default_rng(11)
    vols = rng.standard_normal((1, 1, 1024, 28, 28)).astype(np.float32)
    mask = np.zeros((1, 1024), bool)
    mask[0, 1000:] = True
    probs_ref, sal_ref = _forward_with_saliency(
        jm, {"params": jparams}, jnp.asarray(vols), jnp.asarray(mask),
        plane_mode="last", force_flax=True)
    with torch.inference_mode():
        probs, sal = fused_mst_saliency(tm, _t(vols), _t(mask))
    sal_ref = np.asarray(sal_ref)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref),
                               **PROB_TOL)
    np.testing.assert_allclose(sal.numpy(), sal_ref, **SAL_TOL)
    # the maps are ~1e-3 here, so also relative to their largest value
    scale = np.abs(sal_ref).max()
    np.testing.assert_allclose(sal.numpy() / scale, sal_ref / scale,
                               atol=1e-4)
    assert float(sal[0, 1000:].abs().max()) == 0.0
