"""The train CLI's `--optimizer adafactor` and `--accumulate_grad_batches`
on the CPU against `mst_tpu` (optax 0.2.6):

- `Adafactor` against `optax.adafactor(lr, multiply_by_parameter_scale=
  False, weight_decay_rate=wd)` over 5 updates on a tree with factored,
  unfactored (second largest dim < 128), 4-D, tied-shape and vector
  leaves: the parameters and the second-moment state (the same shapes:
  `v_row` / `v_col` where optax factors, `v` where it does not) to 1e-6
  relative; and against the JAX `make_optimizer(optimizer="adafactor")`
  with `grad_clip`, a warmup-cosine schedule and a frozen encoder (which
  gets neither state nor update);
- `MultiSteps` against `optax.MultiSteps` (the JAX `make_optimizer(...,
  accumulate_steps=k)`) with k = 2 and 3, AdamW and Adafactor, under a
  schedule: every micro-step's parameters to 1e-6, the k - 1 skipped
  micro-steps leaving every parameter bit for bit, the schedule read at
  the update count (optax's inner count), the mini-step and update count
  equal to optax's;
- two epochs of `Trainer.fit` with Adafactor and k = 3 (a window across
  the epoch's end) against the JAX `Trainer.fit` with the same
  `make_optimizer`, same weights and batches: every parameter's move
  within 5% of lr (the key third of each packed qkv bias: an Adafactor
  step's bound, see tests/test_torch_trainer.py::
  test_two_adamw_steps_match_jax_make_train_step);
- `--resume` through the CLI in the middle of an accumulation window
  (Adafactor, k = 3, two micro-batches an epoch): the `last` parameters,
  Adafactor state, running mean, mini-step and counts equal two
  uninterrupted epochs' bit for bit."""

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
from mst_tpu.train.trainer import Trainer as JaxTrainer
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets.synthetic import Synthetic_Dataset3D
from mst_tpu_torch.models.convert import params_from_flax
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.trainer import (
    Adafactor,
    MultiSteps,
    Trainer,
    TrainState,
    factored_dims,
    lr_schedule,
    make_optimizer,
)

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
LEAVES = {  # name: shape (optax's factored dims in the comment)
    "encoder/w": (160, 300),   # (0, 1)
    "head/k": (256, 384),      # (0, 1)
    "head/t": (128, 128),      # tied: argsort's order
    "head/u": (64, 300),       # second largest < 128: not factored
    "head/c": (3, 130, 2, 140),  # 4-D: (1, 3)
    "head/b": (300,),          # a vector
}
CLI = ["--dataset", "Synthetic", "--model_size", "tiny", "--fusion_heads",
       "4", "--dtype", "float32", "--batch_size", "4", "--num_train_samples",
       "8", "--lr", "1e-3", "--patience", "5"]
SYNTH = dict(device="cpu", shape_cdhw=(1, 2, 28, 28), num_samples=8)


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _params_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    p0 = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
          for k, s in LEAVES.items()}
    grads = [{k: (rng.standard_normal(s) * rng.uniform(0.1, 3.0)).astype(
        np.float32) for k, s in LEAVES.items()} for _ in range(steps)]
    return p0, grads


def _torch_params(p0, frozen=()):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    for k in frozen:
        ps[k].requires_grad_(False)
    return ps


def _close(ours, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * scale,
                               err_msg=what)


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for shape in [*LEAVES.values(), (128, 127), (127, 128), (1, 1000),
                  (200, 200, 3), (5,), ()]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128), shape


def test_adafactor_matches_optax_adafactor_and_its_state():
    lr, wd, steps = 1e-2, 1e-2, 5
    p0, grads = _params_and_grads(0, steps)
    tx = optax.adafactor(lr, multiply_by_parameter_scale=False,
                         weight_decay_rate=wd)
    jp = _tree(p0)
    js = tx.init(jp)
    ps = _torch_params(p0)
    opt = make_optimizer(ps.values(), lr, wd, optimizer="adafactor")
    assert isinstance(opt, Adafactor)
    for i, g in enumerate(grads):
        up, js = tx.update(_tree(g), js, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.update()
        for k, v in _flat(jp).items():
            _close(ps[k].detach().numpy(), v, f"step {i} {k}")
    fs = js[0]  # the chain's first state: optax's FactoredState
    assert int(fs.count) == opt.count == steps
    v_row, v_col, v = _flat(fs.v_row), _flat(fs.v_col), _flat(fs.v)
    for k, p in ps.items():
        st = opt.state[p]
        if factored_dims(LEAVES[k]) is None:
            assert set(st) == {"v"} and v_row[k].shape == (1,)
            _close(st["v"].numpy(), v[k], f"v {k}")
        else:
            assert set(st) == {"v_row", "v_col"} and v[k].shape == (1,)
            assert st["v_row"].shape == v_row[k].shape, k
            assert st["v_col"].shape == v_col[k].shape, k
            _close(st["v_row"].numpy(), v_row[k], f"v_row {k}")
            _close(st["v_col"].numpy(), v_col[k], f"v_col {k}")


@pytest.mark.parametrize("kw", [
    dict(grad_clip=5.0),
    dict(schedule="warmup_cosine", total_steps=6, warmup_steps=2),
    dict(frozen=True, grad_clip=5.0, schedule="cosine", total_steps=4)])
def test_adafactor_matches_jax_make_optimizer(kw):
    """Clipping (below the grads' norm, so it acts), a schedule (whose
    first update at lr 0 only decays), a frozen encoder."""
    kw = dict(kw)
    frozen = kw.pop("frozen", False)
    lr, wd, steps = 1e-2, 1e-2, 5
    p0, grads = _params_and_grads(1, steps)
    tx = jax_make_optimizer(lr, wd, freeze_encoder=frozen,
                            optimizer="adafactor", **kw)
    jp = _tree(p0)
    js = tx.init(jp)
    ps = _torch_params(p0, ["encoder/w"] if frozen else ())
    opt = make_optimizer(ps.values(), lr, wd, optimizer="adafactor", **kw)
    sched = lr_schedule(kw.get("schedule"), lr, kw.get("total_steps", 1),
                        kw.get("warmup_steps", 0))
    for i, g in enumerate(grads):
        up, js = tx.update(_tree(g), js, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        opt.update()
        if sched is not None:
            assert opt.param_groups[0]["lr"] == sched(i)
        for k, v in _flat(jp).items():
            _close(ps[k].detach().numpy(), v, f"step {i} {k}")
    if frozen:
        np.testing.assert_array_equal(ps["encoder/w"].detach().numpy(),
                                      p0["encoder/w"])
        assert ps["encoder/w"] not in opt.state


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k, optimizer):
    lr, wd, micro = 1e-2, 1e-2, 7
    kw = dict(schedule="warmup_cosine", total_steps=5, warmup_steps=1)
    p0, grads = _params_and_grads(2, micro)
    tx = jax_make_optimizer(lr, wd, optimizer=optimizer,
                            accumulate_steps=k, **kw)
    jp = _tree(p0)
    js = tx.init(jp)
    ps = _torch_params(p0)
    opt = make_optimizer(ps.values(), lr, wd, optimizer=optimizer,
                         accumulate_steps=k, **kw)
    assert isinstance(opt, MultiSteps)
    sched = lr_schedule(kw["schedule"], lr, 5, 1)
    for i, g in enumerate(grads):
        up, js = tx.update(_tree(g), js, jp)
        jp = optax.apply_updates(jp, up)
        before = {n: p.detach().clone() for n, p in ps.items()}
        for n, p in ps.items():
            p.grad = torch.from_numpy(g[n])
        opt.update()
        emitted = (i + 1) % k == 0
        assert opt.mini_step == int(js.mini_step) == (i + 1) % k
        assert opt.count == int(js.gradient_step) == (i + 1) // k
        for n, p in ps.items():
            if not emitted:  # a skipped micro-step: a true no-op
                assert torch.equal(p.detach(), before[n]), (i, n)
            _close(p.detach().numpy(), _flat(jp)[n], f"micro {i} {n}")
        if emitted:  # the schedule at the update count, not the micro-step
            assert opt.param_groups[0]["lr"] == sched(opt.count - 1)


def _fit_pair(tmp_path, lr, wd, k):
    """Two epochs of both trainers (Adafactor, k micro-batches an update)
    from the same weights -> (flat start, port params, JAX params)."""
    kw = dict(num_samples=8, shape_cdhw=(1, 2, 28, 28))
    rng = np.random.default_rng(7)
    jm = JaxMST(out_ch=2, use_flash=False, **TINY)
    x0 = jnp.zeros((1, 1, 2, 28, 28), jnp.float32)
    flat = _flat(jm.init(jax.random.PRNGKey(7), x0)["params"])
    for key in flat:
        if key.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    jdm = JaxDataModule(ds_train=JaxSynth(**kw), ds_val=JaxSynth(seed=1, **kw),
                        batch_size=2, num_train_samples=8, seed=3)
    jtrainer = JaxTrainer(tmp_path / "jax", max_epochs=2, patience=10)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=_tree(flat),
        tx=jax_make_optimizer(lr, wd, optimizer="adafactor",
                              accumulate_steps=k),
        dropout_rng=jax.random.PRNGKey(0))
    jstate, _ = jtrainer.fit(jm, jstate, jdm)
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **TINY), flat)
    dm = DataModule(ds_train=Synthetic_Dataset3D(**kw),
                    ds_val=Synthetic_Dataset3D(seed=1, **kw), batch_size=2,
                    num_train_samples=8, seed=3)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, wd,
                                          optimizer="adafactor",
                                          accumulate_steps=k))
    state, result = Trainer(tmp_path / "port", max_epochs=2,
                            patience=10).fit(state, dm)
    assert result.epochs_run == 2 and state.step == 8
    assert state.optimizer.count == 8 // k
    assert state.optimizer.mini_step == int(
        jstate.opt_state.mini_step) == 8 % k
    return flat, tm, _flat(jstate.params)


def test_two_epochs_of_fit_with_adafactor_and_accumulation_match_jax(
        tmp_path):
    lr, wd, k = 1e-3, 1e-2, 3
    flat, tm, jflat = _fit_pair(tmp_path, lr, wd, k)
    updates = 8 // k
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        ref = jflat[key] - flat[key]
        if key.endswith(("attn/qkv/bias", "self_attn/in_proj/bias")):
            # the key third's grads are rounding noise, which Adafactor
            # scales to steps of up to lr * sqrt(len) (block rms <= 1)
            e = ours.shape[0] // 3
            bound = updates * (lr * np.sqrt(e * 3) + wd * np.abs(
                flat[key]).max()) * 1.001
            assert np.abs(ours[e:2 * e]).max() <= bound, name
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


def test_resume_in_the_middle_of_a_window_is_bit_identical(tmp_path):
    opts = ["--optimizer", "adafactor", "--accumulate_grad_batches", "3",
            "--lr_schedule", "warmup_cosine"]
    run_a, _ = cli.main(CLI + opts + [
        "--max_epochs", "2", "--run_dir", str(tmp_path / "a")], **SYNTH)
    run_b, _ = cli.main(CLI + opts + [
        "--max_epochs", "1", "--run_dir", str(tmp_path / "b")], **SYNTH)
    mid = _last(run_b)
    assert int(mid["optimizer.npz:mini_step"]) == 2  # inside the window
    assert int(mid["optimizer.npz:count"]) == 0
    assert int(mid["optimizer.npz:state_step"]) == 2
    run_c, res_c = cli.main(CLI + opts + [
        "--max_epochs", "2", "--run_dir", str(tmp_path / "c"),
        "--resume", str(run_b)], **SYNTH)
    assert run_c == run_b and res_c.epochs_run == 1
    a, c = _last(run_a), _last(run_c)
    assert a.keys() == c.keys()
    assert int(a["optimizer.npz:count"]) == 1
    assert int(a["optimizer.npz:mini_step"]) == 1
    params = {k.split(":", 1)[1]: v for k, v in a.items()
              if k.startswith("params.npz:")}
    for kind, want in (("v_row", lambda d: d is not None),
                       ("v", lambda d: d is None)):
        assert sorted(k.split("/", 1)[1] for k in a
                      if k.startswith(f"optimizer.npz:{kind}/")) == sorted(
            k for k, v in params.items() if want(factored_dims(v.shape)))
    assert any(k.startswith("optimizer.npz:acc_grads/") for k in a)
    assert not any("exp_avg" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    hist = [json.loads(line) for line in
            (run_c / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in hist] == [0, 1]
    # a state written with accumulation does not load into a run without
    with pytest.raises(KeyError, match="gradient accumulation"):
        cli.main(CLI + ["--optimizer", "adafactor", "--max_epochs", "3",
                        "--resume", str(run_b)], **SYNTH)


@pytest.mark.parametrize("argv,value", [
    (["--optimizer", "adafactor"], ("adafactor", 1)),
    (["--accumulate_grad_batches", "4"], ("adamw", 4)),
    ([], ("adamw", 1))])
def test_train_cli_parses_the_optimizer_flags(argv, value):
    args = cli.parse_args(argv)
    assert (args.optimizer, args.accumulate_grad_batches) == value
    with pytest.raises(SystemExit):
        cli.parse_args(["--optimizer", "sgd"])
