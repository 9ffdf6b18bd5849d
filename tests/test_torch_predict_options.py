"""The port's predict CLI options `--get_segmentation`, `--get_attention`
and `--ensemble` on the CPU against `scripts/main_predict.main`, on the
same weights: each tiny model is drawn once in flax (O(1) LayerScale, so
that every block shapes the saliency), saved as a JAX run folder (orbax)
and as the port's (`params.npz`), and both CLIs score the Synthetic test
split (16 cases, both raters' masks on every one) in f32.

- `--get_segmentation --save_saliency`: `results.csv` and
  `results_seg.csv` rows within 1e-4 (NaN where JAX has NaN), the mean ±
  std log lines, `seg.nii.gz` equal to JAX's;
- `--get_attention`: the PNGs of the positive cases only, `input.png` and
  `ground_truth.png` equal to JAX's pixel for pixel, `attention.png` too
  but for pixels where the two frameworks' saliency rounds across a
  colormap entry;
- `--ensemble` of two different runs (with a saliency mode) within 1e-4
  of JAX's ensemble; the run with itself three times equal to the run
  alone; a member of another architecture or a folder that is no run is
  refused; other folds and unrecorded folds are logged."""

import csv
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from PIL import Image

from mst_tpu.registry import get_model as jax_get_model
from mst_tpu.utils.checkpoint import save_best_checkpoint as jax_save_best
from mst_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mst_tpu_torch import predict
from mst_tpu_torch.models.convert import params_from_flax
from mst_tpu_torch.registry import get_model
from mst_tpu_torch.utils.checkpoint import (
    save_best_checkpoint,
    save_checkpoint,
)
from mst_tpu_torch.utils.nifti import read_nifti
from scripts.main_predict import main as jax_predict_main

MODEL = "DinoV2ClassifierSlice"
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
TOL = 1e-4
SEG = ("Dice", "IoU", "ASSD")
SHAPE = (1, 8, 56, 56)  # the Synthetic volumes of both CLIs


def _run_pair(root, name, seed, fold=0, **kw):
    """(JAX run folder, port run folder) holding the same seeded weights."""
    cfg = {**TINY, **kw}
    jm, _ = jax_get_model(MODEL, **cfg)
    x = jnp.zeros((1, 1, 2, 28, 28), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tree = jax.tree_util.tree_map(jnp.asarray, flax_unflatten(flat))
    jrun = root / "jax" / "Synthetic" / f"{MODEL}_{name}"
    hp = {"model": MODEL, "dataset": "Synthetic", **cfg}
    if fold is not None:
        hp["fold"] = fold
    jax_save_checkpoint(jrun, "epoch=0", {"params": tree, "step": 0},
                        hparams=hp)
    jax_save_best(jrun, "epoch=0")
    tm = params_from_flax(get_model(MODEL, **cfg), flat)
    trun = root / "port" / "Synthetic" / f"{MODEL}_{name}"
    save_checkpoint(trun, "epoch=0", tm, hparams={
        "model": MODEL, "dataset": "Synthetic", "path_root": None,
        **({} if fold is None else {"fold": fold}), **tm.config})
    save_best_checkpoint(trun, "epoch=0")
    return jrun, trun


def flax_unflatten(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    return {"a": _run_pair(root, "a", 11), "b": _run_pair(root, "b", 12),
            "fold1": _run_pair(root, "f", 13, fold=1),
            "nofold": _run_pair(root, "n", 14, fold=None),
            "wide": _run_pair(root, "w", 15, fusion_heads=2,
                              use_bottleneck=True)}


def _rows(path):
    with path.open() as f:
        return list(csv.DictReader(f))


@pytest.fixture
def jax_synthetic(monkeypatch):
    """The JAX CLI's Synthetic split at SHAPE: 4 x 4 patches a slice, so
    that the saliency's top voxels are not the clamped corners the
    trilinear upsampling copies from a 2 x 2 grid (ties that leave the
    0.999-quantile mask empty)."""
    import scripts.main_predict as jax_cli

    real = jax_cli.get_dataset
    monkeypatch.setattr(jax_cli, "get_dataset", lambda name, **kw: real(
        name, shape_cdhw=SHAPE, **kw))


def _both(tmp_path, jrun, trun, flags, jflags=None, tflags=None):
    """Run both CLIs with `flags` -> (JAX output dir, port output dir)."""
    jout, tout = tmp_path / "jax_out", tmp_path / "port_out"
    jax_predict_main(["--run_folder", str(jrun), "--output_dir", str(jout),
                      *flags, *(jflags or [])])
    predict.main(["--run_folder", str(trun), "--output_dir", str(tout),
                  "--dtype", "float32", *flags, *(tflags or [])],
                 device="cpu", shape_cdhw=SHAPE)
    return jout, tout


def _check_results(jout, tout, n=16):
    ref, ours = _rows(jout / "results.csv"), _rows(tout / "results.csv")
    assert len(ours) == len(ref) == n
    for r, o in zip(ref, ours):
        assert (o["uid"], o["GT"]) == (r["uid"], r["GT"])
        assert float(o["NN_pred"]) == pytest.approx(float(r["NN_pred"]),
                                                    abs=TOL)
        if abs(float(r["NN_pred"]) - 0.5) > TOL:
            assert o["NN"] == r["NN"]
    return ours


def _num(field):
    """A results_seg.csv cell: NaN is written as an empty field (pandas)."""
    return float(field) if field else math.nan


def _check_seg(jout, tout, n=16):
    ref, ours = _rows(jout / "results_seg.csv"), _rows(tout /
                                                       "results_seg.csv")
    assert len(ours) == len(ref) == n
    assert list(ours[0]) == ["uid", "GT", "NN", *SEG]
    for r, o in zip(ref, ours):
        assert (o["uid"], o["GT"], o["NN"]) == (r["uid"], r["GT"], r["NN"])
        for m in SEG:
            a, b = _num(o[m]), _num(r[m])
            assert math.isnan(a) == math.isnan(b), (r["uid"], m, a, b)
            if not math.isnan(b):
                assert a == pytest.approx(b, abs=TOL), (r["uid"], m)
    log = (tout / "predict.log").read_text()
    for m in SEG:
        vals = np.array([_num(o[m]) for o in ours])
        assert f"{m}: {np.nanmean(vals):.4f} ± {np.nanstd(vals):.4f}" in log
    return ours


def test_get_segmentation_matches_main_predict(runs, tmp_path,
                                               jax_synthetic):
    jrun, trun = runs["a"]
    jout, tout = _both(tmp_path, jrun, trun,
                       ["--get_segmentation", "--save_saliency"])
    _check_results(jout, tout)
    ours = _check_seg(jout, tout)
    # seeded weights do not find the blob (Dice 0), but the distances are
    # measured: both masks have a surface there
    assert sum(math.isfinite(_num(o["ASSD"])) for o in ours) >= 4
    for o in ours:
        case = f"case_{o['uid']}"
        seg, aff = read_nifti(tout / case / "seg.nii.gz")
        ref, _ = read_nifti(jout / case / "seg.nii.gz")
        assert seg.dtype == np.uint8 and seg.shape == (56, 56, 8)
        np.testing.assert_array_equal(seg, ref)
        np.testing.assert_allclose(aff, np.eye(4))
        sal, _ = read_nifti(tout / case / "saliency.nii.gz")
        jsal, _ = read_nifti(jout / case / "saliency.nii.gz")
        np.testing.assert_allclose(sal, jsal, rtol=0,
                                   atol=TOL * float(np.abs(jsal).max()))


def test_get_attention_matches_main_predict(runs, tmp_path, jax_synthetic):
    jrun, trun = runs["a"]
    jout, tout = _both(tmp_path, jrun, trun, ["--get_attention"])
    rows = _check_results(jout, tout)
    written = sorted(p.name for p in tout.glob("case_*"))
    assert written == sorted(f"case_{r['uid']}" for r in rows
                             if r["GT"] == "1")
    assert written == sorted(p.name for p in jout.glob("case_*"))
    for case in written:
        for name in ("input.png", "ground_truth.png", "attention.png"):
            ours = np.asarray(Image.open(tout / case / name))
            ref = np.asarray(Image.open(jout / case / name))
            assert ours.shape == ref.shape == (56, 448, 4), (case, name)
            if name != "attention.png":
                np.testing.assert_array_equal(ours, ref, err_msg=case)
                continue
            # a colormap entry is 1/256 of the clipped map's range: the
            # two frameworks' saliency may round across one
            differ = np.abs(ours.astype(int) - ref).max(-1) > 0
            assert differ.mean() <= 0.01, (case, differ.mean())
            assert np.abs(ours.astype(int) - ref).max() <= 64, case


def test_ensemble_of_two_runs_matches_main_predict(runs, tmp_path, caplog,
                                                   jax_synthetic):
    (ja, ta), (jb, tb) = runs["a"], runs["b"]
    with caplog.at_level(logging.INFO, logger="mst_tpu_torch.predict"):
        jout, tout = _both(tmp_path, ja, ta, ["--get_segmentation"],
                           jflags=["--ensemble", str(jb)],
                           tflags=["--ensemble", str(tb)])
    _check_results(jout, tout)
    _check_seg(jout, tout)
    assert "ensemble of 2 models" in (tout / "predict.log").read_text()


def test_ensemble_of_a_run_with_itself_is_the_run(runs, tmp_path):
    _, trun = runs["a"]
    alone, triple = tmp_path / "alone", tmp_path / "triple"
    predict.main(["--run_folder", str(trun), "--output_dir", str(alone),
                  "--dtype", "float32", "--batch_size", "4"], device="cpu")
    predict.main(["--run_folder", str(trun), "--output_dir", str(triple),
                  "--dtype", "float32", "--batch_size", "4", "--ensemble",
                  str(trun), str(trun)], device="cpu")
    assert _rows(triple / "results.csv") == _rows(alone / "results.csv")


def test_ensemble_refusals_and_fold_logs(runs, tmp_path, caplog):
    _, trun = runs["a"]
    argv = ["--run_folder", str(trun), "--output_dir", str(tmp_path / "o"),
            "--dtype", "float32", "--batch_size", "16", "--ensemble"]
    with pytest.raises(SystemExit, match="different architecture"):
        predict.main(argv + [str(runs["wide"][1])], device="cpu")
    with pytest.raises(SystemExit, match="not a run folder"):
        predict.main(argv + [str(tmp_path)], device="cpu")
    with caplog.at_level(logging.INFO, logger="mst_tpu_torch.predict"):
        predict.main(argv + [str(runs["fold1"][1]), str(runs["nofold"][1])],
                     device="cpu")
    text = caplog.text
    assert "trained on fold 1 (this run: fold 0)" in text
    assert f"fold not recorded for {runs['nofold'][1]}" in text
    assert "ensemble of 3 models" in text
