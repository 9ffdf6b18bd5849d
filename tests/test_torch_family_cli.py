"""The CLIs on the model families of this round, on the CPU: `ResNet` (the
3D ResNet50), `ResNetSliceTrans` (MST-ResNet34) and tiny MST-DINO models
with `--slice_fusion average`, `--slice_fusion linear` and `--rotary
LiRE`, on Synthetic volumes in f32:

- `python -m mst_tpu_torch.train` two epochs, then `predict --run_folder
  --use_tta --get_attention` against `scripts/main_predict.py` on the same
  weights (the port's best checkpoint, BatchNorm statistics included,
  saved as a JAX run folder): `results.csv` rows within 1e-4, the same
  positive cases' PNGs;
- `serve.load_run_model` rebuilds the model with the checkpoint's
  statistics (and a `linear` head's slice count from its kernel);
- one epoch and `--resume` for the second equal two epochs bit for bit
  (parameters, AdamW state, BatchNorm statistics)."""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from mst_tpu.utils.checkpoint import save_best_checkpoint as jax_save_best
from mst_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mst_tpu_torch import predict, serve
from mst_tpu_torch.models.convert import flax_batch_stats_from_torch
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.utils.checkpoint import (
    load_best_batch_stats,
    load_best_params,
    load_hparams,
    resolve_best_checkpoint,
)
from scripts.main_predict import main as jax_predict_main

TOL = 1e-4
RUNS = {
    "ResNet": ["--model", "ResNet"],
    "ResNetSliceTrans": ["--model", "ResNetSliceTrans"],
    "average": ["--model_size", "tiny", "--fusion_heads", "4",
                "--slice_fusion", "average"],
    "linear": ["--model_size", "tiny", "--fusion_heads", "4",
               "--slice_fusion", "linear"],
    "LiRE": ["--model_size", "tiny", "--fusion_heads", "4", "--rotary",
             "LiRE"],
}
COMMON = ["--dataset", "Synthetic", "--dtype", "float32", "--batch_size",
          "4", "--num_train_samples", "8", "--lr", "1e-3", "--patience", "5"]
SHAPES = {"ResNet": (1, 4, 32, 32), "ResNetSliceTrans": (1, 4, 32, 32)}
DINO_SHAPE = (1, 4, 28, 28)
N = 8  # Synthetic volumes a split


def _shape(name):
    return SHAPES.get(name, DINO_SHAPE)


def _train(tmp_path, name, sub, epochs, resume=None):
    argv = COMMON + RUNS[name] + ["--max_epochs", str(epochs), "--run_dir",
                                  str(tmp_path / sub)]
    if resume is not None:
        argv += ["--resume", str(resume)]
    return cli.main(argv, device="cpu", shape_cdhw=_shape(name),
                    num_samples=N)


def _jax_run(tmp_path, run):
    """The port run folder's best checkpoint as a JAX (orbax) run folder."""
    hp = load_hparams(run)
    tree = {"params": _tree(load_best_params(run)), "step": 0}
    stats = load_best_batch_stats(run)
    if stats is not None:
        tree["batch_stats"] = _tree(stats)
    jrun = tmp_path / "jax" / "Synthetic" / f"{hp['model']}_x"
    jax_save_checkpoint(jrun, "epoch=0", tree, hparams=hp)
    jax_save_best(jrun, "epoch=0")
    return jrun


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _rows(path):
    with path.open() as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("name", list(RUNS))
def test_train_predict_serve_resume(tmp_path, monkeypatch, name):
    run_a, res_a = _train(tmp_path, name, "a", 2)
    hp = load_hparams(run_a)
    model_name = "DinoV2ClassifierSlice" if name in (
        "average", "linear", "LiRE") else name
    assert hp["model"] == model_name and res_a.epochs_run == 2
    stats = load_best_batch_stats(run_a)
    assert (stats is not None) == name.startswith("ResNet")

    # serve.load_run_model: the best checkpoint's params and statistics
    model = serve.load_run_model(run_a)
    params = load_best_params(run_a)
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), params[n.replace(".", "/")])
    if stats is not None:
        got = flax_batch_stats_from_torch(model)
        assert set(got) == set(stats)
        assert all(np.array_equal(got[k], stats[k]) for k in stats)
        assert any(not np.all(stats[k] == 0) for k in stats
                   if k.endswith("/mean"))  # the steps moved them
    if name == "linear":
        assert model.num_slices == _shape(name)[1]

    # predict --run_folder vs scripts/main_predict.py on the same weights
    import scripts.main_predict as jax_cli

    real = jax_cli.get_dataset
    monkeypatch.setattr(jax_cli, "get_dataset", lambda n, **kw: real(
        n, shape_cdhw=_shape(name), num_samples=N, **kw))
    jrun = _jax_run(tmp_path, run_a)
    flags = ["--use_tta", "--get_attention"]
    jout, tout = tmp_path / "jax_out", tmp_path / "port_out"
    jax_predict_main(["--run_folder", str(jrun), "--output_dir", str(jout),
                      *flags])
    predict.main(["--run_folder", str(run_a), "--output_dir", str(tout),
                  "--dtype", "float32", *flags], device="cpu",
                 shape_cdhw=_shape(name), num_samples=N)
    ref, ours = _rows(jout / "results.csv"), _rows(tout / "results.csv")
    assert len(ours) == len(ref) == N
    for r, o in zip(ref, ours):
        assert (o["uid"], o["GT"]) == (r["uid"], r["GT"])
        assert abs(float(o["NN_pred"]) - float(r["NN_pred"])) <= TOL
    pngs = sorted(p.relative_to(tout).as_posix()
                  for p in tout.glob("case_*/*.png"))
    assert pngs and pngs == sorted(p.relative_to(jout).as_posix()
                                   for p in jout.glob("case_*/*.png"))

    # one epoch, then --resume for the second: the `last` state bit for bit
    run_b, _ = _train(tmp_path, name, "b", 1)
    run_c, res_c = _train(tmp_path, name, "c", 2, resume=run_b)
    assert run_c == run_b and res_c.epochs_run == 1
    files = ["params.npz", "optimizer.npz"] + (
        ["batch_stats.npz"] if stats is not None else [])
    for f in files:
        with np.load(run_a / "last" / f) as za, np.load(run_c / "last" / f) \
                as zc:
            assert za.files == zc.files
            for k in za.files:
                np.testing.assert_array_equal(za[k], zc[k], err_msg=k)
    assert json.loads((run_c / "last.meta.json").read_text())["epoch"] == 1
    assert resolve_best_checkpoint(run_c).startswith("epoch=")
    # the best checkpoint serves through the port's predict fn too
    probs, _ = make_predict_fn(serve.load_run_model(run_c),
                               with_saliency=False)(
        np.zeros((1, *_shape(name)), np.float32))
    assert tuple(probs.shape) == (1, 2) and bool(torch.isfinite(probs).all())
