"""The train CLI's options of `make_optimizer` and `Trainer` on the CPU
against `mst_tpu`:

- `lr_schedule` against optax's `cosine_decay_schedule` and
  `warmup_cosine_decay_schedule` at steps 0 .. 100,500, both in f64
  (optax evaluated with x64 on: in f32 the cosine near its end is a
  difference of ones that rounds to 0 or to an ulp): relative 1e-6;
- `clip_by_global_norm` against optax's on the same grads, the norm below,
  at and above the limit, on a frozen model (the encoder holds no grad and
  no share of the norm): relative 1e-7 of optax in f64, 2 f32 ulps of
  optax in f32;
- two steps with `schedule="warmup_cosine"` and `grad_clip` against the
  JAX `make_train_step` with the same `make_optimizer`, to the limits of
  `tests/test_torch_trainer.py`'s two AdamW steps;
- `--resume` through the CLI on tiny Synthetic (as
  `tests/test_train_e2e.py:148`): one epoch, then `--resume` for a second,
  equals two uninterrupted epochs in the parameters and both moments bit
  for bit, in the same run folder; a folder that is not a run is refused;
- `--profile_dir`: a Chrome trace of epoch 1."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu_torch.models.convert import params_from_flax
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import (
    TrainState,
    clip_by_global_norm,
    lr_schedule,
    make_optimizer,
    make_train_step,
)

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
STEPS = (0, 1, 499, 500, 501, 99_999, 100_000, 100_500)
CLI = ["--dataset", "Synthetic", "--model_size", "tiny", "--fusion_heads",
       "4", "--dtype", "float32", "--batch_size", "4", "--num_train_samples",
       "8", "--lr", "1e-3", "--patience", "5"]
SYNTH = dict(device="cpu", shape_cdhw=(1, 2, 28, 28), num_samples=8)


@pytest.mark.parametrize("name", ["cosine", "warmup_cosine"])
def test_lr_schedules_match_optax(name):
    lr = 3e-4
    ours = lr_schedule(name, lr, 100_000, 500)
    with jax.enable_x64(True):
        ref = (optax.cosine_decay_schedule(lr, 100_000) if name == "cosine"
               else optax.warmup_cosine_decay_schedule(0.0, lr, 500, 100_000))
        want = [float(ref(jnp.asarray(s, jnp.float64))) for s in STEPS]
    got = [ours(s) for s in STEPS]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert lr_schedule(None, lr) is None
    if name == "warmup_cosine":
        assert got[0] == 0.0 and got[3] == pytest.approx(lr, rel=1e-12)
    assert got[-2] == got[-1] == 0.0  # the end of the cosine, and past it


def _frozen_grads(seed):
    """A frozen tiny model whose trained parameters hold seeded grads."""
    model = DinoSliceClassifier(out_ch=2, freeze=True, **TINY)
    rng = np.random.default_rng(seed)
    grads = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32))
            grads[name.replace(".", "/")] = p.grad.numpy().copy()
    return model, grads


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_clip_by_global_norm_matches_optax(where):
    """optax's clip on the same grads in f64 (x64 on), rounded to f32, is
    the reference at 1e-7; optax in f32 differs from it by its own f32
    norm, an ulp off the exact one here, and is held to the port within 2
    ulps of f32 (2.4e-7)."""
    model, grads = _frozen_grads(0)
    assert not any(k.startswith("encoder/") for k in grads)
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads.values())))
    max_norm = {"below": 2.0 * norm, "at": norm, "above": 0.25 * norm}[where]

    def optax_clip(dtype):
        tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v, dtype)
                               for k, v in grads.items()})
        tx = optax.clip_by_global_norm(max_norm)
        out, _ = tx.update(tree, tx.init(tree))
        return {k: np.asarray(v).astype(np.float32)
                for k, v in flatten_dict(out, sep="/").items()}

    with jax.enable_x64(True):
        ref = optax_clip(jnp.float64)
    ref32 = optax_clip(jnp.float32)
    clip_by_global_norm(list(model.parameters()), max_norm)
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        if key not in grads:
            assert p.grad is None, name  # the frozen encoder
            continue
        got = p.grad.numpy()
        np.testing.assert_allclose(got, ref[key], rtol=1e-7, atol=0,
                                   err_msg=key)
        np.testing.assert_allclose(got, ref32[key], rtol=2.4e-7, atol=0,
                                   err_msg=key)
        if where == "below":
            np.testing.assert_array_equal(got, grads[key])
        if where == "at":  # norm == max: scaled by exactly 1
            np.testing.assert_array_equal(got, grads[key])


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JaxMST(out_ch=2, use_flash=False, **TINY)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:, :, :2]))[
        "params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **TINY), flat)
    return jm, flat, tm, x


def test_two_scheduled_clipped_steps_match_jax_make_train_step():
    """`schedule="warmup_cosine"` (warmup 1 of 10 steps: the first step at
    lr 0 moves only the moments, the second at the peak) and `grad_clip`
    below the grads' norm, against the JAX `make_train_step` with
    `make_optimizer(..., grad_clip, schedule)`: the losses to 1e-5 and the
    parameters' moves to 5% of lr, but the key third of each qkv bias
    (a softmax-invariant direction, see
    tests/test_torch_trainer.py::test_two_adamw_steps_match_jax_make_train_step)."""
    lr, wd, clip = 1e-3, 1e-2, 0.5
    shape = (2, 1, 3, 28, 28)
    jm, flat, tm, x = _pair(shape, seed=1)
    x2 = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    t = np.arange(2) % 2
    kw = dict(grad_clip=clip, schedule="warmup_cosine", total_steps=10,
              warmup_steps=1)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, tx=jax_make_optimizer(lr, wd, **kw),
        params=unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                               for k, v in flat.items()}),
        dropout_rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, wd, **kw))
    step = make_train_step(state)
    lrs = []
    for xb in (x, x2):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(xb), jnp.asarray(t), None)
        loss, _ = step(torch.from_numpy(xb), torch.from_numpy(t))
        lrs.append(state.optimizer.param_groups[0]["lr"])
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
        clipped = np.sqrt(sum(float((p.grad.double() ** 2).sum())
                              for p in tm.parameters()))
        assert clipped == pytest.approx(clip, rel=1e-6)  # the clip acted
    assert lrs == [0.0, lr]
    jflat = flatten_dict(jstate.params, sep="/")
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        ref = np.asarray(jflat[key]) - flat[key]
        if key.endswith(("attn/qkv/bias", "self_attn/in_proj/bias")):
            e = ours.shape[0] // 3  # [q | k | v]
            assert np.abs(ours[e:2 * e]).max() <= lr * (1.0 + 1e-3), name
            ours, ref = np.delete(ours, np.s_[e:2 * e]), np.delete(
                ref, np.s_[e:2 * e])
        np.testing.assert_allclose(ours, ref, atol=0.05 * lr, rtol=0,
                                   err_msg=name)


def _last(run_dir):
    out = {}
    for f in ("params.npz", "optimizer.npz"):
        with np.load(run_dir / "last" / f, allow_pickle=False) as z:
            out.update({f"{f}:{k}": z[k] for k in z.files})
    return out


def test_resume_through_the_cli_is_bit_identical(tmp_path):
    """Two epochs against one epoch and `--resume` for the second, with a
    schedule: the `last` parameters, AdamW moments and steps and the update
    count equal bit for bit, the resumed run stays in its folder, and a
    folder without `best_checkpoint.json` is refused."""
    sched = ["--lr_schedule", "warmup_cosine"]
    run_a, res_a = cli.main(CLI + sched + [
        "--max_epochs", "2", "--run_dir", str(tmp_path / "a")], **SYNTH)
    run_b, _ = cli.main(CLI + sched + [
        "--max_epochs", "1", "--run_dir", str(tmp_path / "b")], **SYNTH)
    meta_b = json.loads((run_b / "last.meta.json").read_text())
    assert meta_b["epoch"] == 0
    run_c, res_c = cli.main(CLI + sched + [
        "--max_epochs", "2", "--run_dir", str(tmp_path / "c"),
        "--resume", str(run_b)], **SYNTH)
    assert run_c == run_b and not (tmp_path / "c").exists()
    assert res_c.epochs_run == 1  # epoch 1 only
    a, c = _last(run_a), _last(run_c)
    assert a.keys() == c.keys()
    assert any(k.startswith("optimizer.npz:exp_avg_sq/") for k in a)
    assert int(a["optimizer.npz:state_step"]) == 4  # 2 epochs of 2 steps
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    hist = [json.loads(line) for line in
            (run_c / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in hist] == [0, 1]
    assert json.loads((run_c / "last.meta.json").read_text())["epoch"] == 1
    with pytest.raises(SystemExit, match="not a run folder"):
        cli.main(CLI + ["--resume", str(tmp_path / "a")], **SYNTH)


def test_profile_dir_writes_the_second_epochs_trace(tmp_path):
    prof = tmp_path / "prof"
    cli.main(CLI + ["--max_epochs", "2", "--run_dir", str(tmp_path / "r"),
                    "--profile_dir", str(prof)], **SYNTH)
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
