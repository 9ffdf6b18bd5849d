"""`train --freeze --int8 [--int8_calib N]` on the CPU against `mst_tpu`:

- `quantize_frozen_encoder_int8` leaf by leaf against the JAX
  `quantize_mst_params_int8({"encoder": ...}, model, calib)`: the codes
  bit for bit, the folded static scales to 2e-5 (as
  tests/test_torch_int8.py);
- the frozen int8 step (as tests/test_fused_int8.py:272-322) on a JAX
  quantized encoder carried across: its logits against JAX
  `fused_mst_logits(train=True)` with `params["encoder"]` swapped (1e-4 of
  the largest), the slice fusion's and head's grads against `jax.grad`
  (5e-4), no grad and no change in the bf16 encoder, and the step's
  logits equal to the int8 serving forward's bit for bit;
- the refusals: an unfrozen model (`make_train_step`, `Trainer.fit`, the
  CLI's `--int8` without `--freeze`, JAX's message), and above
  FUSED_MAX_TOKENS the step's warning and the unquantized encoder;
- the CLI: one epoch and `--resume` for the second equal two epochs bit
  for bit (the calibration draws the first train volumes and leaves the
  epoch's sampling as it was), the checkpoints hold the unquantized
  encoder, and the eval step scores on the int8 encoder."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.vit_fast import fused_mst_logits as jax_fused_mst_logits
from mst_tpu.ops import fused_int8 as jq
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D
from mst_tpu_torch.models.convert import params_from_flax, quantized_from_flax
from mst_tpu_torch.models.layers import QDense
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import fused_mst_logits
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tq
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    cross_entropy_loss,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from mst_tpu_torch.utils.checkpoint import load_best_params
from mst_tpu_torch.utils.metrics import ClassificationMetrics

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
CLI = ["--dataset", "Synthetic", "--model_size", "tiny", "--fusion_heads",
       "4", "--dtype", "float32", "--batch_size", "4", "--num_train_samples",
       "8", "--lr", "1e-3", "--patience", "5", "--freeze"]
SYNTH = dict(device="cpu", shape_cdhw=(1, 2, 28, 28), num_samples=8)


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _pair(seed, shape=(2, 1, 4, 28, 28)):
    """(frozen jax model, flat params with O(1) LayerScale, frozen port
    model with them, volume)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JaxMST(out_ch=2, use_flash=False, freeze=True, **TINY)
    flat = _flat(jm.init(jax.random.PRNGKey(seed),
                         jnp.asarray(x[:, :, :2]))["params"])
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, freeze=True, **TINY),
                          flat)
    return jm, flat, tm, x


def _close_rel(ours, ref, rel, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale, what


@pytest.mark.parametrize("static", [False, True])
def test_quantize_frozen_encoder_matches_mst_tpu(static):
    jm, flat, tm, x = _pair(1)
    calib = x if static else None
    ours = tq.quantize_frozen_encoder_int8(tm, calib, dtype=torch.float32)
    ref = _flat(jq.quantize_mst_params_int8(
        {"encoder": _tree(flat)["encoder"]}, jm if static else None,
        None if calib is None else jnp.asarray(calib),
        dtype=jnp.float32)["encoder"])
    got = {k.replace(".", "/"): v.detach().numpy()
           for k, v in ours.state_dict().items()}
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.dtype == np.int8 or not static:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=2e-5, err_msg=k)
    # only the encoder was copied: the model's own is untouched
    assert isinstance(ours.blocks_0.attn.qkv, QDense)
    assert isinstance(tm.encoder.blocks_0.attn.qkv.kernel, torch.nn.Parameter)


def test_frozen_int8_step_matches_jax_train_forward_and_grads():
    jm, flat, tm, x = _pair(2)
    target = np.array([0, 1])
    qenc = jq.quantize_mst_params_int8(
        {"encoder": _tree(flat)["encoder"]})["encoder"]

    def loss_fn(p):
        fp = dict(p)
        fp["encoder"] = qenc
        logits = jax_fused_mst_logits(fp, jnp.asarray(x), jm,
                                      dtype=jnp.float32, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(target)).mean(), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        _tree(flat))
    flat_q = {**{k: v for k, v in flat.items()
                 if not k.startswith("encoder/")},
              **{f"encoder/{k}": v for k, v in _flat(qenc).items()}}
    enc8 = quantized_from_flax(tm, flat_q).encoder
    enc_before = {k: v.clone() for k, v in tm.encoder.state_dict().items()}
    tfb.reset_launch_counts()
    logits = fused_mst_logits(tm, torch.from_numpy(x), dtype=torch.float32,
                              train=True, encoder=enc8)
    cross_entropy_loss(logits, torch.from_numpy(target)).backward()
    assert set(tfb.launch_counts().values()) == {0}  # CPU: plain versions
    _close_rel(logits.detach().numpy(), jlogits, 1e-4, "logits")
    jflat = _flat(jgrads)
    for name, p in tm.named_parameters():
        if name.startswith("encoder."):
            assert p.grad is None and not p.requires_grad, name
            continue
        _close_rel(p.grad.numpy(), jflat[name.replace(".", "/")], 5e-4, name)
    with torch.no_grad():
        serve = fused_mst_logits(tm, torch.from_numpy(x),
                                 dtype=torch.float32, encoder=enc8)
    assert torch.equal(serve, logits.detach())
    # a step through `make_train_step`: the encoder keeps its bits
    step = make_train_step(TrainState(tm, make_optimizer(tm.parameters(),
                                                         1e-3)), enc8)
    step(torch.from_numpy(x), torch.from_numpy(target))
    for k, v in tm.encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k
    with pytest.raises(ValueError, match="serve only"):
        fused_mst_logits(DinoSliceClassifier(out_ch=2, **TINY),
                         torch.from_numpy(x), train=True, encoder=enc8)


def test_int8_training_requires_a_frozen_encoder(tmp_path):
    model = DinoSliceClassifier(out_ch=2, **TINY)
    enc8 = tq.quantize_encoder_int8(model.encoder)
    with pytest.raises(ValueError, match="requires a frozen encoder"):
        make_train_step(TrainState(model, make_optimizer(model.parameters())),
                        enc8)
    ds = Synthetic_Dataset3D(num_samples=4, shape_cdhw=(1, 2, 28, 28))
    dm = DataModule(ds_train=ds, ds_val=ds, batch_size=2)
    trainer = Trainer(tmp_path / "r", max_epochs=1, int8=True)
    with pytest.raises(ValueError, match="--int8 training requires --freeze"):
        trainer.fit(trainer.init_state(model), dm)
    argv = [a for a in CLI if a != "--freeze"] + [
        "--int8", "--max_epochs", "1", "--run_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--int8 training requires --freeze"):
        cli.main(argv, **SYNTH)
    args = cli.parse_args(CLI + ["--int8", "--int8_calib", "3"])
    assert args.freeze and args.int8 and args.int8_calib == 3


def test_int8_step_above_fused_max_tokens_warns_and_runs_unquantized(
        caplog):
    """322 px slices (530 tokens) take the composed path, which has no int8
    encoder: the step logs JAX's warning once and trains on the model's
    own encoder, as the step without one does."""
    _, _, tm, _ = _pair(3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 1, 1, 322, 322)).astype(np.float32))
    t = torch.tensor([1])
    enc8 = tq.quantize_frozen_encoder_int8(tm)
    ref = make_eval_step(tm)(x)
    with caplog.at_level(logging.WARNING):
        got = make_eval_step(tm, enc8)(x)
        step = make_train_step(TrainState(tm, make_optimizer(
            tm.parameters(), 0.0)), enc8)
        _, logits = step(x, t)
        step(x, t)
    assert torch.equal(got, ref) and torch.equal(logits, ref)
    warned = [r for r in caplog.records if "--int8 ignored" in r.getMessage()]
    assert len(warned) == 2  # once a step function


def _last(run_dir):
    out = {}
    for f in ("params.npz", "optimizer.npz"):
        with np.load(run_dir / "last" / f, allow_pickle=False) as z:
            out.update({f"{f}:{k}": z[k] for k in z.files})
    return out


def test_frozen_int8_fit_resume_and_checkpoints_through_the_cli(tmp_path):
    opts = CLI + ["--int8", "--int8_calib", "3"]
    run_a, res_a = cli.main(opts + ["--max_epochs", "2", "--run_dir",
                                    str(tmp_path / "a")], **SYNTH)
    run_b, _ = cli.main(opts + ["--max_epochs", "1", "--run_dir",
                                str(tmp_path / "b")], **SYNTH)
    run_c, res_c = cli.main(opts + ["--max_epochs", "2", "--resume",
                                    str(run_b)], **SYNTH)
    assert run_c == run_b and res_c.epochs_run == 1
    a, c = _last(run_a), _last(run_c)
    assert a.keys() == c.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    # the checkpoints hold the seeded, unquantized encoder
    seeded = DinoSliceClassifier(out_ch=2, freeze=True, **TINY)
    Trainer(tmp_path / "s").init_state(seeded, seed=0)
    best = load_best_params(run_a)
    assert not any(k.endswith("/q8") for k in best)
    for name, p in seeded.named_parameters():
        if name.startswith("encoder."):
            key = name.replace(".", "/")
            np.testing.assert_array_equal(best[key], p.detach().numpy())
            np.testing.assert_array_equal(a[f"params.npz:{key}"],
                                          p.detach().numpy())
    assert np.isfinite(res_a.history[-1]["train_loss"])


def test_fit_scores_validation_on_the_int8_encoder(tmp_path):
    """The val AUC of an lr-0 int8 run is that of the int8 serving model's
    logits, and the calibration leaves the DataModule's epoch as it was."""
    _, _, tm, _ = _pair(4)
    ds = Synthetic_Dataset3D(num_samples=8, shape_cdhw=(1, 2, 28, 28))
    dm = DataModule(ds_train=ds, ds_val=ds, batch_size=4,
                    num_train_samples=8)
    trainer = Trainer(tmp_path, max_epochs=1, int8=True, int8_calib=3)
    enc8 = trainer.int8_encoder(tm, dm)
    assert dm._epoch == 0
    assert enc8.blocks_0.mlp.fc2.a_inv is not None  # static scales
    state = TrainState(tm, make_optimizer(tm.parameters(), 0.0, 0.0))
    _, res = trainer.fit(state, dm)
    metrics = ClassificationMetrics()
    for b in dm.val_dataloader():
        metrics.update(make_eval_step(tm, enc8)(b["source"]).numpy(),
                       b["target"])
    assert res.history[0]["val/AUC_ROC"] == metrics.compute()["AUC_ROC"]
    with torch.no_grad():  # not the unquantized model's
        b = next(iter(dm.val_dataloader()))
        assert not torch.equal(make_eval_step(tm)(b["source"]),
                               make_eval_step(tm, enc8)(b["source"]))
