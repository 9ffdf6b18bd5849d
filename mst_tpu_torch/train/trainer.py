"""Training loop: the fused train step, val-AUC early stopping, top-1
checkpoints.

Counterpart of `mst_tpu/train/trainer.py` on one card (`make_train_step`
of the standard DinoSliceClassifier configuration):

- the step runs `mst_logits(train=True)`, routed as the JAX step routes
  (:237-266): a ResNet's own forward with batch statistics, which moves
  its running BatchNorm statistics (JAX's `mutable=["batch_stats"]`); else
  by the slice size: the fused path (every block but the last on
  the residual-saving sub-layers, whose backward is a chain of
  hand-written kernels, each block checkpointed with the model's `remat`;
  a frozen encoder on the serving sub-layers under `no_grad`) or, above
  `FUSED_MAX_TOKENS` tokens per slice, the composed path (the flash
  kernels and their backward; `remat` and `freeze` as well), CE in f32,
  `loss.backward()`, and an update set up as `make_optimizer` (:54-121):
  optax `adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on
  every parameter it holds; with a frozen encoder over the slice fusion
  and head only) or `adafactor` (`Adafactor`), a constant learning rate
  or optax's `cosine` / `warmup_cosine` schedule at the update count,
  optionally optax's `clip_by_global_norm` before it, and with
  `accumulate_steps` k optax's `MultiSteps` around all of it
  (`MultiSteps`: one update every k micro-batches);
- a frozen model's step can run its encoder on an int8 copy
  (`int8_encoder`, `train --freeze --int8`: the W8A8 serving sub-layers
  under `no_grad`, the slice fusion and head trained in full precision on
  the features int8 serving produces, :469-531);
- the eval step runs the serving forward under `torch.inference_mode()`,
  routed the same way (:365-385), on the int8 encoder where the step has
  one;
- `Trainer.fit` (:419-452, 465-686) runs sanity val steps (a fresh run
  only), the epoch loop from `start_epoch` (each batch's
  `src_key_padding_mask`, where its dataset pads slices, into the train
  and eval steps; per-step results drained to the host every 64 steps, so
  no step waits for the card; a `torch.profiler` trace of epoch index 1
  with `profile_dir`),
  midrank AUC on the validation split, `history.jsonl` with the JAX keys
  (including `perf/*` from `utils.profiling.StepTimer`), the top-1
  `epoch=N/` checkpoint with `best_checkpoint.json`, the full train state
  `last/` after every epoch (`utils.checkpoint.TrainStateWriter`, written
  on a background thread that `fit` joins before it returns), and early
  stopping with patience and `min_epochs`, whose counters a resumed run
  takes from `last.meta.json`; with `int8` the frozen encoder is
  quantized once at the start of `fit` (calibrated with `int8_calib` on
  the first train volumes, the sampling epoch restored after).
"""

from __future__ import annotations

import json
import logging
import math
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mst_tpu_torch.models.convert import (
    initial_batch_stats,
    params_from_flax,
    random_flax_params,
)
from mst_tpu_torch.models.vit_fast import (
    check_int8_config,
    fused_seq_len_ok,
    int8_config_supported,
    mst_logits,
)
from mst_tpu_torch.utils.checkpoint import (
    TrainStateWriter,
    save_best_checkpoint,
    save_checkpoint,
)
from mst_tpu_torch.utils.metrics import ClassificationMetrics
from mst_tpu_torch.utils.profiling import StepTimer, trace

log = logging.getLogger(__name__)

MONITOR = "AUC_ROC"  # val metric of early stopping and the best checkpoint
SANITY_VAL_STEPS = 2  # Lightning's num_sanity_val_steps (reference default)
DRAIN_EVERY = 64  # steps whose results wait on the card before a host read


def lr_schedule(schedule: Optional[str], learning_rate: float,
                total_steps: int = 100_000, warmup_steps: int = 500):
    """-> count -> learning rate, or None for a constant rate. optax's
    `cosine_decay_schedule(lr, total_steps)` (alpha 0, exponent 1) and
    `warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)` (a
    linear ramp from 0, then the cosine over the remaining steps), in
    double precision."""
    def cosine(peak, steps):
        def at(count):
            c = min(float(count), float(steps))
            return peak * (0.5 * (1 + math.cos(math.pi * c / steps)))
        return at

    if schedule is None:
        return None
    if schedule == "cosine":
        return cosine(learning_rate, total_steps)
    if schedule == "warmup_cosine":
        decay = cosine(learning_rate, total_steps - warmup_steps)

        def at(count):
            if count < warmup_steps:
                frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
                return (0.0 - learning_rate) * frac + learning_rate
            return decay(count - warmup_steps)
        return at
    raise ValueError(f"unknown schedule {schedule!r}")


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax `clip_by_global_norm` on the grads of `params`, in place: the
    norm over every grad, and where it is at least `max_norm` each grad
    becomes (g / norm) * max_norm, as optax computes it (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). The norm and the scaling run in f64
    and round once to the grad's dtype (optax's f32 sum of squares lands an
    ulp either side of the exact norm, by its summation order). On the
    device, with no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    trigger = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g.double() / norm * max_norm, g))


class _Scheduled:
    """The optax extras of `make_optimizer` that both optimizers share:
    `update()` clips the grads (`grad_clip`), sets every group's learning
    rate to the schedule at the update count `count` (for AdamW the
    decoupled decay follows it, as optax's `adamw` scales its decay by the
    schedule), steps and counts the update."""

    STATE = ()  # the per-parameter state `last/optimizer.npz` keeps

    def _extras(self, grad_clip, schedule) -> None:
        self.grad_clip = grad_clip
        self.schedule = schedule
        self.count = 0  # updates made: the schedule's count

    def held(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def update(self) -> None:
        if self.grad_clip:
            clip_by_global_norm(self.held(), self.grad_clip)
        if self.schedule is not None:
            lr = self.schedule(self.count)
            for group in self.param_groups:
                group["lr"] = lr
        self.step()
        self.count += 1


class ScheduledAdamW(_Scheduled, torch.optim.AdamW):
    """AdamW with the optax extras of `make_optimizer` (`_Scheduled`)."""

    STATE = ("exp_avg", "exp_avg_sq", "step")

    def __init__(self, params, learning_rate: float, weight_decay: float,
                 grad_clip: Optional[float] = None, schedule=None):
        super().__init__(params, lr=learning_rate, betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self._extras(grad_clip, schedule)


# optax 0.2.6 `adafactor`'s defaults (`optax/_src/alias.py:225-238`)
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0


def factored_dims(shape) -> Optional[tuple]:
    """optax's `_factored_dims`: the (second largest, largest) dims of a
    leaf whose two largest dims are at least 128, else None (vectors
    included); ties ordered by `np.argsort`, as optax orders them. The
    port keeps every kernel in its flax shape, so the same dims factor."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Scheduled, torch.optim.Optimizer):
    """optax `adafactor(lr, multiply_by_parameter_scale=False,
    weight_decay_rate=wd)` at optax 0.2.6's defaults
    (`mst_tpu/train/trainer.py:100-102`), with the extras of `_Scheduled`.
    Per parameter, at update t (from 1), beta = 1 - t^-0.8 and g2 = g^2 +
    1e-30:

    - a leaf with two dims of at least 128 keeps the factored second
      moment: `v_row` (the mean of g2 over the largest dim) and `v_col`
      (over the second largest), each `beta * v + (1 - beta) * mean`, and
      u = g * (v_row / mean(v_row))^-1/2 * v_col^-1/2 broadcast back;
      every other leaf keeps `v` = beta * v + (1 - beta) * g2 and u = g *
      v^-1/2;
    - `clip_by_block_rms(1)`: u / max(1, rms(u));
    - p <- p - (lr * u + wd * p): optax adds the decay after the learning
      rate's scaling, so unlike AdamW the decay is not scaled by it (at wd
      1e-2 every weight shrinks 1% an update; ROADMAP, known differences).

    A parameter without a grad takes a zero grad, as a leaf of optax's
    tree does. The state is f32 like the parameters."""

    STATE = ("v_row", "v_col", "v")

    def __init__(self, params, learning_rate: float, weight_decay: float,
                 grad_clip: Optional[float] = None, schedule=None):
        super().__init__(params, dict(lr=learning_rate,
                                      weight_decay=weight_decay))
        self._extras(grad_clip, schedule)

    @torch.no_grad()
    def step(self, closure=None):
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        beta = 1.0 - t ** -ADAFACTOR_DECAY_RATE
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                b = beta.to(p.device)
                st = self.state[p]
                g2 = g * g + ADAFACTOR_EPS
                dims = factored_dims(tuple(p.shape))
                if dims is not None:
                    d1, d0 = dims
                    if not st:
                        st["v_row"] = torch.zeros_like(g2.mean(d0))
                        st["v_col"] = torch.zeros_like(g2.mean(d1))
                    v_row = b * st["v_row"] + (1.0 - b) * g2.mean(d0)
                    v_col = b * st["v_col"] + (1.0 - b) * g2.mean(d1)
                    rd1 = d1 - 1 if d1 > d0 else d1
                    row = (v_row / v_row.mean(rd1, keepdim=True)) ** -0.5
                    u = g * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                    st["v_row"], st["v_col"] = v_row, v_col
                else:
                    if not st:
                        st["v"] = torch.zeros_like(p)
                    v = b * st["v"] + (1.0 - b) * g2
                    u = g * v ** -0.5
                    st["v"] = v
                u = u / torch.clamp(u.square().mean().sqrt() / ADAFACTOR_CLIP,
                                    min=1.0)
                p.add_(-(lr * u + wd * p))


class MultiSteps:
    """optax `MultiSteps(opt, every_k_schedule=k)` around an optimizer of
    `make_optimizer` (`mst_tpu/train/trainer.py:119-120`): `update()` folds
    the micro-batch's grads into their running mean, acc + (g - acc) /
    (n + 1) (a missing grad as zero), and on every k-th call hands the mean
    to the inner optimizer's `update()` (clipping, schedule and all) and
    zeroes it; the k - 1 calls between leave the parameters and the inner
    state as they were. So the schedule reads the inner update count, not
    the micro-batches. The mean and `mini_step` carry over an epoch's end,
    and `last/optimizer.npz` keeps them (`acc_grads/<key>`, `mini_step`)."""

    def __init__(self, inner, every_k: int):
        if every_k < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc = {p: torch.zeros_like(p) for p in inner.held()}

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @property
    def STATE(self):
        return self.inner.STATE

    @property
    def count(self) -> int:
        return self.inner.count

    @count.setter
    def count(self, value: int) -> None:
        self.inner.count = value

    def held(self) -> list:
        return self.inner.held()

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def update(self) -> None:
        n = self.mini_step
        for p, acc in self.acc.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.acc[p] = acc + (g - acc) / (n + 1)
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return
        for p, acc in self.acc.items():
            p.grad = acc
        self.inner.update()
        self.acc = {p: torch.zeros_like(p) for p in self.acc}
        self.mini_step = 0


OPTIMIZERS = {"adamw": ScheduledAdamW, "adafactor": Adafactor}


def make_optimizer(params, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2,
                   grad_clip: Optional[float] = None,
                   schedule: Optional[str] = None,
                   total_steps: int = 100_000,
                   warmup_steps: int = 500, optimizer: str = "adamw",
                   accumulate_steps: int = 1):
    """optax `adamw(learning_rate, weight_decay=weight_decay)`, or with
    `optimizer="adafactor"` optax's `adafactor` (`Adafactor`): one group,
    so the decay reaches every parameter (optax masks no leaf: biases, LN,
    LayerScale and the tokens decay too). AdamW is PyTorch's default
    implementation; the update is the same algebra: p -= lr * (m^ /
    (sqrt(v^) + eps) + wd * p).
    `schedule` None (constant), "cosine" or "warmup_cosine" (`lr_schedule`),
    evaluated at the update count before each update; `grad_clip` chains
    `clip_by_global_norm` before the update; `accumulate_steps` k > 1 wraps
    it all in `MultiSteps` (one update every k micro-batches).

    It holds the parameters that require grad: a frozen model's encoder
    (`DinoSliceClassifier(freeze=True)`) does not, so it is neither stepped
    nor decayed nor counted in the clipping norm, and has no state, as
    under the JAX `make_optimizer(freeze_encoder=True)`."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    opt = OPTIMIZERS[optimizer](
        [p for p in params if p.requires_grad], learning_rate, weight_decay,
        grad_clip, lr_schedule(schedule, learning_rate, total_steps,
                               warmup_steps))
    return MultiSteps(opt, accumulate_steps) if accumulate_steps > 1 else opt


def cross_entropy_loss(logits, targets):
    return F.cross_entropy(logits.float(), targets.long())


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _int8_route(model, int8_encoder):
    """-> fn(source) -> the encoder a step runs on this input: the int8
    copy where the slices fit the fused kernels, else None (the model's
    own) with JAX's warning, once (`mst_tpu/train/trainer.py:524-527`)."""
    warned = []

    def encoder_for(source):
        if int8_encoder is None or fused_seq_len_ok(model,
                                                    *source.shape[-2:]):
            return int8_encoder
        if not warned:
            log.warning("--int8 ignored: fused train path unavailable for "
                        "this model/backend (slices above FUSED_MAX_TOKENS)")
            warned.append(True)
        return None

    return encoder_for


def make_train_step(state: TrainState, int8_encoder=None):
    """-> step(source, target, mask) -> (loss, logits), device tensors, no
    host synchronisation. One call is one micro-batch: the optimizer's
    `update()` (one update of `state.model` in place, or with `MultiSteps`
    one every k calls); `state.step` counts the calls. A frozen model
    (`model.freeze`) runs the frozen form of either path, its encoder
    replaced by `int8_encoder` where one is given; a model whose encoder the
    fused kernels cannot train on its device raises before any forward work
    (`check_trainable`)."""
    model, optimizer = state.model, state.optimizer
    if int8_encoder is not None:
        check_int8_config(model)
    if int8_encoder is not None and not model.freeze:
        raise ValueError(
            "int8_encoder requires a frozen encoder (model.freeze): training "
            "THROUGH int8 weights is not supported — the quantized forward "
            "has no meaningful weight gradients")
    encoder_for = _int8_route(model, int8_encoder)

    def step(source, target, mask=None):
        optimizer.zero_grad(set_to_none=True)
        logits = mst_logits(model, source, mask, train=True,
                            encoder=encoder_for(source))
        loss = cross_entropy_loss(logits, target)
        loss.backward()
        optimizer.update()
        state.step += 1
        return loss.detach(), logits.detach()

    return step


def make_eval_step(model, int8_encoder=None):
    """Validation forward on the serving kernels -> logits [B, classes];
    on `int8_encoder` where the train step has one, so that validation
    scores the features the slice fusion and head learn on. A ResNet
    normalises by its running BatchNorm statistics."""
    if int8_encoder is not None:
        check_int8_config(model)
    encoder_for = _int8_route(model, int8_encoder)

    @torch.inference_mode()
    def step(source, mask=None):
        return mst_logits(model, source, mask, encoder=encoder_for(source))

    return step


@dataclass
class FitResult:
    best_metric: float
    best_epoch: int
    epochs_run: int
    history: list


class Trainer:
    """Fit loop with val-AUC early stopping and the top-1 checkpoint
    policy."""

    def __init__(self, run_dir, max_epochs: int = 1000, min_epochs: int = 1,
                 patience: int = 10, limit_val_batches: Optional[int] = None,
                 keep_last: bool = True, profile_dir=None,
                 num_sanity_val_steps: int = SANITY_VAL_STEPS,
                 int8: bool = False, int8_calib: int = 0):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.patience = patience
        self.limit_val_batches = limit_val_batches
        self.keep_last = keep_last
        self.profile_dir = profile_dir
        self.num_sanity_val_steps = num_sanity_val_steps
        self.int8, self.int8_calib = int8, int8_calib
        self.state_writer = TrainStateWriter()  # `last`, after every epoch

    def init_state(self, model, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2, seed: int = 0,
                   **optimizer_kw) -> TrainState:
        """Seeded random weights in the flax layout, and the optimizer over
        them (over the slice fusion and head for a frozen model);
        `optimizer_kw` go to `make_optimizer` (grad_clip, schedule,
        total_steps, warmup_steps, optimizer, accumulate_steps)."""
        params_from_flax(model, random_flax_params(model, seed),
                         initial_batch_stats(model))
        return TrainState(model, make_optimizer(
            model.parameters(), learning_rate, weight_decay, **optimizer_kw))

    def int8_encoder(self, model, dm):
        """--int8: the frozen encoder quantized once
        (`quantize_frozen_encoder_int8`), its static scales calibrated on
        the first `int8_calib` train volumes as the loader serves them; the
        DataModule's sampling epoch is restored after, so that the epochs
        (and a --resume) draw what they would have drawn
        (`mst_tpu/train/trainer.py:469-531`). A configuration outside
        `int8_config_supported` trains unquantized, with JAX's warning.
        The model keeps its own encoder: its checkpoints hold the
        unquantized weights."""
        from mst_tpu_torch.ops.fused_int8 import quantize_frozen_encoder_int8

        if not model.freeze:
            raise ValueError("--int8 training requires --freeze (only the "
                             "frozen encoder forward may run quantized)")
        if not int8_config_supported(model):
            # JAX's fit (:532-534): int8 params run only on the fused gate
            log.warning("--int8 ignored: fused train path unavailable for "
                        "this model/backend")
            return None
        calib = None
        if self.int8_calib:
            epoch, vols = dm._epoch, []
            for batch in dm.train_dataloader():
                vols.append(torch.as_tensor(batch["source"]))
                if sum(len(v) for v in vols) >= self.int8_calib:
                    break
            dm.set_epoch(epoch)
            if vols:
                calib = torch.cat(vols)[:self.int8_calib]
        enc = quantize_frozen_encoder_int8(model, calib)
        log.info("frozen encoder trains on int8 (W8A8) serving kernels (%s "
                 "activation scales)", "dynamic per-token" if calib is None
                 else "static calibrated")
        return enc

    def fit(self, state: TrainState, dm, hparams: Optional[Dict] = None,
            start_epoch: int = 0, resume_meta: Optional[Dict] = None) -> tuple:
        """Epochs `start_epoch` .. max_epochs - 1; a resumed run passes the
        restored state, the next epoch and `last.meta.json`'s counters."""
        model = state.model
        device = next(model.parameters()).device
        int8_enc = self.int8_encoder(model, dm) if self.int8 else None
        train_step = make_train_step(state, int8_enc)
        eval_step = make_eval_step(model, int8_enc)
        best, best_epoch, stale = -np.inf, -1, 0
        if resume_meta:  # continue the early-stop bookkeeping exactly
            best = float(resume_meta.get("best", best))
            best_epoch = int(resume_meta.get("best_epoch", best_epoch))
            stale = int(resume_meta.get("stale", stale))
        if start_epoch:
            dm.set_epoch(start_epoch)  # the sampling continues where it was
        history = []

        def target_of(batch):
            # pinned and non_blocking: the copy does not wait for the steps
            # queued before it
            t = torch.from_numpy(batch["target"])
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, torch.long, non_blocking=True)

        # Lightning's sanity check (reference `num_sanity_val_steps=2`): an
        # eval-path fault fails in seconds, not after the first epoch.
        if self.num_sanity_val_steps and start_epoch == 0:
            for bi, batch in enumerate(dm.val_dataloader()):
                if bi >= self.num_sanity_val_steps:
                    break
                eval_step(batch["source"], batch.get("src_key_padding_mask"))

        timer = StepTimer()
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            train_metrics = ClassificationMetrics()
            n_steps, loss_sum = 0, 0.0
            # Results stay on the card and come to the host in blocks: no
            # step waits for the one before it.
            pending = []

            def drain():
                nonlocal loss_sum
                if not pending:
                    return
                losses = torch.stack([p[0] for p in pending]).cpu()
                logits = torch.cat([p[1] for p in pending]).float().cpu()
                loss_sum += float(losses.sum())
                train_metrics.update(logits.numpy(),
                                     np.concatenate([p[2] for p in pending]))
                pending.clear()

            with trace(self.profile_dir if epoch == 1 else None):
                for batch in dm.train_dataloader():
                    with timer.step():
                        loss, logits = train_step(
                            batch["source"], target_of(batch),
                            batch.get("src_key_padding_mask"))
                    pending.append((loss, logits, batch["target"]))
                    n_steps += 1
                    if len(pending) >= DRAIN_EVERY:
                        drain()
                drain()

            val_metrics = ClassificationMetrics()
            val_valid = dm.eval_valid_mask(len(dm.ds_val))
            for bi, batch in enumerate(dm.val_dataloader()):
                if self.limit_val_batches and bi >= self.limit_val_batches:
                    break
                logits = eval_step(batch["source"],
                                   batch.get("src_key_padding_mask"))
                lo = bi * dm.batch_size
                val_metrics.update(logits.float().cpu().numpy(),
                                   batch["target"],
                                   valid=val_valid[lo:lo + dm.batch_size])

            tm, vm = train_metrics.compute(), val_metrics.compute()
            metric = vm[MONITOR]
            row = {
                "epoch": epoch,
                "train_loss": loss_sum / max(n_steps, 1),
                **{f"train/{k}": v for k, v in tm.items()},
                **{f"val/{k}": v for k, v in vm.items()},
                "seconds": time.time() - t0,
                **{f"perf/{k}": v
                   for k, v in timer.stats(dm.batch_size).items()},
            }
            history.append(row)
            log.info("epoch %d loss %.4f train/AUC %.3f val/AUC %.3f (%.1fs)",
                     epoch, row["train_loss"], tm["AUC_ROC"], vm["AUC_ROC"],
                     row["seconds"])
            with (self.run_dir / "history.jsonl").open("a") as fh:
                fh.write(json.dumps(row) + "\n")

            if np.isnan(metric):
                metric = -np.inf
            # the first epoch is always banked, even at a NaN metric (a
            # one-class val split), so that every run has a best checkpoint
            if metric > best or best_epoch < 0:
                prev = f"epoch={best_epoch}" if best_epoch >= 0 else None
                best, best_epoch, stale = metric, epoch, 0
                name = f"epoch={epoch}"
                save_checkpoint(self.run_dir, name, model, hparams=hparams)
                save_best_checkpoint(self.run_dir, name)
                if prev:  # top-1 policy: drop the superseded best
                    shutil.rmtree(self.run_dir / prev, ignore_errors=True)
                    (self.run_dir / f"{prev}.hparams.json").unlink(
                        missing_ok=True)
            else:
                stale += 1
            if self.keep_last:
                # the full train state and the loop's counters, so that
                # --resume continues this run, not a warm start; the write
                # overlaps the next epoch
                self.state_writer.save(
                    self.run_dir, "last", state,
                    meta={"epoch": epoch, "best": float(best),
                          "best_epoch": best_epoch, "stale": stale},
                    hparams=hparams)
            if epoch + 1 >= self.min_epochs and stale >= self.patience:
                log.info("early stopping at epoch %d (best %.4f @ %d)",
                         epoch, best, best_epoch)
                break
        self.state_writer.wait()  # `last` is on disk before fit returns
        return state, FitResult(float(best), best_epoch, len(history),
                                history)
