"""The port's train path (`mst_tpu_torch.train`, `utils`, `data`) on the CPU
against `mst_tpu`: model loss and grads of the fused train forward vs flax,
two AdamW steps vs the JAX `make_train_step`, midrank AUC, the flax round
trip of the parameters, the data pipeline's draws, the trainer's early
stopping and checkpoint policy, and the train CLI's builders end to end.

Sizes are the test-only `tiny` model on [2, 1, D, 28, 28] volumes, f32."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.data.datamodule import DataModule as JaxDataModule
from mst_tpu.data.datasets.synthetic import Synthetic_Dataset3D as JaxSynth
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.registry import MODELS as JAX_MODELS
from mst_tpu.registry import get_dataset as jax_get_dataset
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu.utils.metrics import ClassificationMetrics as JaxMetrics
from mst_tpu.utils.metrics import binary_auroc as jax_auroc
from mst_tpu.utils.metrics import confusion_matrix as jax_confusion_matrix
from mst_tpu_torch import serve
from mst_tpu_torch.data.datamodule import DataModule, balanced_weights
from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D
from mst_tpu_torch.data.transforms import AugmentConfig, augment_batch
from mst_tpu_torch.models.convert import flax_params_from_torch, params_from_flax
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import fused_mst_logits
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.registry import MODELS, get_dataset, get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    cross_entropy_loss,
    make_optimizer,
    make_train_step,
)
from mst_tpu_torch.utils.checkpoint import best_params_path
from mst_tpu_torch.utils.metrics import (
    ClassificationMetrics,
    binary_auroc,
    confusion_matrix,
)

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)  # as tests/test_fused_block.py:226


def _pair(shape, seed=0, mask=None, **kw):
    """(jax model, flat flax params with O(1) LayerScale, port model with the
    same weights, volume, targets)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JaxMST(out_ch=2, use_flash=False, **TINY, **kw)
    init_m = None if mask is None else jnp.asarray(mask[:, :2])
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2]),
                     init_m)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **TINY, **kw), flat)
    return jm, flat, tm, x, np.arange(shape[0]) % 2


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_train_forward_loss_and_grads_match_flax(with_mask):
    """CE(fused_mst_logits(train=True)) and every parameter's grad vs
    jax.grad of the flax model (the template is
    tests/test_fused_block.py:197), through `params_from_flax`."""
    shape = (2, 1, 4, 28, 28)
    mask = None
    if with_mask:
        mask = np.zeros((2, 4), bool)
        mask[0, -2:] = True  # the first volume's last two slices are padding
    jm, flat, tm, x, t = _pair(shape, mask=mask)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss_flax(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), jmask)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(t)).mean()

    jloss, jgrads = jax.value_and_grad(loss_flax)(_tree(flat))
    tfb.reset_launch_counts()
    logits = fused_mst_logits(
        tm, torch.from_numpy(x), None if mask is None else
        torch.from_numpy(mask), train=True)
    loss = cross_entropy_loss(logits, torch.from_numpy(t))
    loss.backward()
    assert set(tfb.launch_counts().values()) == {0}  # CPU: plain versions
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    jflat = flatten_dict(jgrads, sep="/")
    named = dict(tm.named_parameters())
    assert {k.replace(".", "/") for k in named} == set(jflat)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jflat[name.replace(".", "/")]),
                                   **GRAD_TOL, err_msg=name)


def test_two_adamw_steps_match_jax_make_train_step():
    """Parameters after two steps of the port's train step (AdamW, one group,
    weight decay on every parameter) vs the JAX `make_train_step` with
    `make_optimizer` (optax adamw; the flax path on the CPU), same weights
    and batches. lr 1e-3: each step moves a parameter by about lr, and the
    updates must agree to 5% of lr (the grads agree to ~1e-6 relative).

    Except the key third of each packed qkv bias: a key bias adds q . b_k
    to every score of a row, which the softmax ignores, so its grad is 0 in
    exact arithmetic and rounding noise on both sides, which Adam scales up
    to a step of about lr in either direction. There the check is only that
    each step stays an Adam step (|update| <= lr + decay)."""
    lr, wd = 1e-3, 1e-2
    shape = (2, 1, 3, 28, 28)
    jm, flat, tm, x, t = _pair(shape, seed=1)
    x2 = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=_tree(flat),
                                  tx=jax_make_optimizer(lr, wd),
                                  dropout_rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, wd))
    step = make_train_step(state)
    for xb in (x, x2):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(xb), jnp.asarray(t), None)
        loss, _ = step(torch.from_numpy(xb), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    assert state.step == 2
    jflat = flatten_dict(jstate.params, sep="/")
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        ref = np.asarray(jflat[key]) - flat[key]
        if key.endswith(("attn/qkv/bias", "self_attn/in_proj/bias")):
            e = ours.shape[0] // 3  # [q | k | v]
            bound = 2 * lr * (1.0 + 1e-3)  # two steps, decay included
            assert np.abs(ours[e:2 * e]).max() <= bound, name
            ours, ref = np.delete(ours, np.s_[e:2 * e]), np.delete(
                ref, np.s_[e:2 * e])
        np.testing.assert_allclose(ours, ref, atol=0.05 * lr, rtol=0,
                                   err_msg=name)


def test_adamw_matches_optax_adamw_on_the_same_grads():
    """The optimizer alone: three updates from the same grads agree to f32
    rounding (same algebra, decay on every leaf)."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-2, weight_decay=1e-2)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], 1e-2, 1e-2)
    for g in grads:
        up, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=1e-6)


def test_registry_training_fields_match_mst_tpu():
    for name, entry in MODELS.items():
        ref = JAX_MODELS[name]
        assert (entry.learning_rate, entry.weight_decay) == \
            (ref.learning_rate, ref.weight_decay)


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_auroc_matches_mst_tpu_with_ties(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random(200), 1)  # 11 values: many ties
    labels = rng.random(200) < 0.4
    assert binary_auroc(scores, labels) == pytest.approx(
        jax_auroc(scores, labels), abs=1e-12)
    # midranks: the pairwise definition, ties counted one half
    d = scores[labels][:, None] - scores[~labels][None]
    pairwise = ((d > 0) + 0.5 * (d == 0)).mean()
    assert binary_auroc(scores, labels) == pytest.approx(pairwise, abs=1e-12)
    assert np.isnan(binary_auroc(scores, np.zeros(200, bool)))
    logits = rng.standard_normal((200, 2)).astype(np.float32)
    valid = rng.random(200) < 0.9
    ours, ref = ClassificationMetrics(), JaxMetrics()
    for m in (ours, ref):
        m.update(logits[:120], labels[:120], valid=valid[:120])
        m.update(logits[120:], labels[120:], valid=valid[120:])
    assert ours.compute() == pytest.approx(ref.compute(), abs=1e-12)
    pred = logits.argmax(-1)
    np.testing.assert_array_equal(confusion_matrix(pred, labels),
                                  jax_confusion_matrix(pred, labels))


def test_flax_params_round_trip():
    """flax init -> params_from_flax -> flax_params_from_torch gives the same
    flat tree back (names, shapes, values), which flax applies as it is."""
    jm = JaxMST(out_ch=2, use_flash=False, **TINY, use_slice_pos_emb=True,
                num_register_tokens=2)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (1, 1, 2, 28, 28)).astype(np.float32))
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    tm = DinoSliceClassifier(out_ch=2, **TINY, use_slice_pos_emb=True,
                             num_register_tokens=2)
    back = flax_params_from_torch(params_from_flax(tm, flat))
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    np.testing.assert_array_equal(
        np.asarray(jm.apply({"params": _tree(back)}, x)),
        np.asarray(jm.apply({"params": params}, x)))


def test_synthetic_dataset_and_sampling_match_mst_tpu():
    """The same seeded volumes, labels and weighted epoch index streams as
    the JAX dataset and DataModule."""
    kw = dict(num_samples=6, shape_cdhw=(1, 4, 28, 28), seed=3)
    ours, ref = Synthetic_Dataset3D(**kw), JaxSynth(**kw)
    np.testing.assert_array_equal(ours.labels(), ref.labels())
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["uid"] == b["uid"] and a["target"] == b["target"]
        np.testing.assert_array_equal(a["source"], b["source"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    assert dataclasses.asdict(ours.augment_config(True)) == \
        dataclasses.asdict(ref.augment_config(True))
    w = balanced_weights(ours.labels())
    dm = DataModule(ds_train=ours, batch_size=2, weights=w,
                    num_train_samples=5, seed=7)
    jdm = JaxDataModule(ds_train=ref, batch_size=2, weights=w,
                        num_train_samples=5, seed=7)
    for epoch in range(3):
        dm.set_epoch(epoch)
        jdm.set_epoch(epoch)
        np.testing.assert_array_equal(dm._train_indices(),
                                      jdm._train_indices())


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_synthetic_samples_match_mst_tpu_key_for_key(split):
    """Every key of every sample of the registries' Synthetic split equals
    the JAX one (`affine`, `path`, and on the test split the two raters'
    `rater_masks` that `predict --get_segmentation` scores against)."""
    kw = dict(num_samples=5, shape_cdhw=(1, 4, 28, 28), random_center=True,
              random_rotate=True, fold=2, decode_cache=None)
    ours = get_dataset("Synthetic", split, **kw)
    kw.pop("fold")  # the JAX registry passes it on; its dataset has none
    ref = jax_get_dataset("Synthetic", split, **kw)
    assert ours.split == ref.split == split
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys(), (split, i)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert a[k].dtype == v.dtype, (split, i, k)
                np.testing.assert_array_equal(a[k], v, err_msg=k)
            else:
                assert a[k] == v, (split, i, k)
        assert ("rater_masks" in a) == (split == "test")


def test_augment_flip_and_noise():
    """Flips alone give one of the 8 flips of each volume; the draws repeat
    per seed; noise stays within its std bound; clamp, rotation and
    inversion run (`tests/test_torch_data.py` holds each against JAX)."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.standard_normal((4, 1, 3, 5, 6)).astype(
        np.float32))
    seeds = [11, 12, 13, 14]
    out = augment_batch(AugmentConfig(flip=True), True, vol, seeds)
    for i in range(4):
        hits = [dims for dims in ([], [1], [2], [3], [1, 2], [1, 3], [2, 3],
                                  [1, 2, 3])
                if torch.equal(out[i], vol[i].flip(dims) if dims else vol[i])]
        assert len(hits) == 1
    assert torch.equal(out, augment_batch(AugmentConfig(flip=True), True,
                                          vol, seeds))
    diff = augment_batch(AugmentConfig(noise_std=0.1), True, vol, seeds) - vol
    assert 0 < float(diff.std()) < 0.1 and not torch.equal(diff[0], diff[1])
    same = augment_batch(AugmentConfig(flip=True, noise_std=0.1), False, vol,
                         seeds)
    assert torch.equal(same, vol)  # eval: no augmentation
    # the steps the host data path brought: a clamp, a rotation (the angle
    # repeats per seed; bilinear taps stay inside the volume's range) and
    # an inversion (each volume negated or not)
    out = augment_batch(AugmentConfig(clamp_range=(-1.0, 1.0)), True, vol,
                        seeds)
    assert torch.equal(out, vol.clamp(-1.0, 1.0))
    rot = augment_batch(AugmentConfig(random_rotate=True), True, vol, seeds)
    assert torch.equal(rot, augment_batch(AugmentConfig(random_rotate=True),
                                          True, vol, seeds))
    assert not torch.equal(rot, vol)
    assert float(rot.min()) >= float(vol.min()) - 1e-6  # convex taps
    inv = augment_batch(AugmentConfig(invert=True), True, vol, seeds)
    for i in range(4):
        assert torch.equal(inv[i], vol[i]) or torch.equal(inv[i], -vol[i])


def _fit(tmp_path, lr, max_epochs, patience):
    ds = Synthetic_Dataset3D(num_samples=8, shape_cdhw=(1, 2, 28, 28))
    dm = DataModule(ds_train=ds, ds_val=ds, batch_size=4, num_train_samples=8)
    trainer = Trainer(tmp_path, max_epochs=max_epochs, patience=patience)
    state = trainer.init_state(DinoSliceClassifier(out_ch=2, **TINY), lr,
                               seed=0)
    return trainer.fit(state, dm, hparams={"m": "tiny"})


def test_early_stopping_with_zero_lr(tmp_path):
    """lr = 0: the metric never improves after epoch 0, so the run stops
    after 1 + patience epochs (tests/test_trainer_unit.py:33)."""
    _, result = _fit(tmp_path, lr=0.0, max_epochs=10, patience=2)
    assert result.best_epoch == 0
    assert result.epochs_run == 3  # epoch 0 best + 2 stale
    assert (tmp_path / "best_checkpoint.json").exists()
    assert (tmp_path / "epoch=0" / "params.npz").exists()


def test_top1_checkpoint_policy_deletes_superseded(tmp_path):
    """Only the current best epoch's checkpoint survives
    (tests/test_trainer_unit.py:44); the full train state `last` stands
    beside it."""
    _, result = _fit(tmp_path, lr=1e-2, max_epochs=3, patience=10)
    epoch_dirs = [p.name for p in tmp_path.glob("epoch=*") if p.is_dir()]
    assert epoch_dirs == [f"epoch={result.best_epoch}"]
    assert sorted(p.name for p in tmp_path.glob("*.hparams.json")) == \
        [f"epoch={result.best_epoch}.hparams.json", "last.hparams.json"]
    assert (tmp_path / "last" / "params.npz").exists()


def test_train_cli_two_epochs_and_serve_the_best_checkpoint(tmp_path):
    """`python -m mst_tpu_torch.train` through its builders on a tiny model:
    two epochs, history with the JAX keys, the best npz, which
    `serve.load_weights` loads into a model that predicts what the trained
    one does."""
    args = cli.parse_args(["--dataset", "Synthetic", "--dtype", "float32",
                           "--max_epochs", "2", "--batch_size", "4",
                           "--num_train_samples", "8", "--lr", "1e-3",
                           "--use_slice_pos_emb"])
    model = get_model(args.model, **TINY, **cli.model_kwargs(args))
    dm = cli.build_datamodule(args, "cpu", shape_cdhw=(1, 2, 28, 28),
                              num_samples=8)
    trainer = cli.build_trainer(args, dm, run_dir=tmp_path)
    _, result = cli.train(args, model, dm, trainer)
    assert result.epochs_run == 2
    rows = [json.loads(line) for line in (tmp_path / "history.jsonl").open()]
    assert [r["epoch"] for r in rows] == [0, 1]
    for key in ("train_loss", "train/ACC", "train/AUC_ROC", "val/ACC",
                "val/AUC_ROC", "seconds"):
        assert all(key in r for r in rows), key
    assert "perf/p50_ms" in rows[1]  # 4 steps, the first 2 are warm-up
    hp = json.loads((tmp_path / f"epoch={result.best_epoch}.hparams.json"
                     ).read_text())
    assert hp["model"] == "DinoV2ClassifierSlice" and hp["use_slice_pos_emb"]

    served = get_model(args.model, **TINY, **cli.model_kwargs(args))
    serve.load_weights(served, serve.parse_args(
        ["--params_npz", str(best_params_path(tmp_path))]))
    vol = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 1, 2, 28, 28)).astype(np.float32))
    if result.best_epoch == 1:  # the model holds the best epoch's weights
        with torch.no_grad():
            torch.testing.assert_close(fused_mst_logits(served, vol),
                                       fused_mst_logits(model, vol),
                                       atol=0, rtol=0)
    for name, p in served.named_parameters():
        assert torch.isfinite(p).all(), name
