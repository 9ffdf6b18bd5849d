"""Training loop: the fused train step, val-AUC early stopping, top-1
checkpoints.

Counterpart of `mst_tpu/train/trainer.py` on one card (`make_train_step`
of the standard DinoSliceClassifier configuration):

- the step runs `mst_logits(train=True)`, routed by the slice size as the
  JAX step routes (:237-266): the fused path (every block but the last on
  the residual-saving sub-layers, whose backward is a chain of
  hand-written kernels, each block checkpointed with the model's `remat`;
  a frozen encoder on the serving sub-layers under `no_grad`) or, above
  `FUSED_MAX_TOKENS` tokens per slice, the composed path (the flash
  kernels and their backward; `remat` and `freeze` as well), CE in f32,
  `loss.backward()`, and an AdamW update set up as `make_optimizer`
  (:54-121): optax `adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
  decay on every parameter it holds; with a frozen encoder over the slice
  fusion and head only), a constant learning rate or optax's `cosine` /
  `warmup_cosine` schedule at the update count, and optionally optax's
  `clip_by_global_norm` before it;
- the eval step runs the serving forward under `torch.inference_mode()`,
  routed the same way (:365-385);
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
  takes from `last.meta.json`.

Adafactor and gradient accumulation are ROADMAP queue A #12.
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

from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.vit_fast import mst_logits
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


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW with the optax extras of `make_optimizer`: `update(count)`
    clips the grads (`grad_clip`), sets every group's learning rate to the
    schedule at `count` (so the decoupled decay follows it, as optax's
    `adamw` scales its decay by the schedule) and steps."""

    def __init__(self, params, learning_rate: float, weight_decay: float,
                 grad_clip: Optional[float] = None, schedule=None):
        super().__init__(params, lr=learning_rate, betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip
        self.schedule = schedule

    def update(self, count: int) -> None:
        if self.grad_clip:
            clip_by_global_norm(
                [p for g in self.param_groups for p in g["params"]],
                self.grad_clip)
        if self.schedule is not None:
            lr = self.schedule(count)
            for group in self.param_groups:
                group["lr"] = lr
        self.step()


def make_optimizer(params, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2,
                   grad_clip: Optional[float] = None,
                   schedule: Optional[str] = None,
                   total_steps: int = 100_000,
                   warmup_steps: int = 500) -> ScheduledAdamW:
    """optax `adamw(learning_rate, weight_decay=weight_decay)`: one group,
    so the decay reaches every parameter (optax masks no leaf: biases, LN,
    LayerScale and the tokens decay too). PyTorch's default implementation;
    the update is the same algebra: p -= lr * (m^ / (sqrt(v^) + eps) + wd * p).
    `schedule` None (constant), "cosine" or "warmup_cosine" (`lr_schedule`),
    evaluated at the update count before each step; `grad_clip` chains
    `clip_by_global_norm` before the update.

    It holds the parameters that require grad: a frozen model's encoder
    (`DinoSliceClassifier(freeze=True)`) does not, so it is neither stepped
    nor decayed nor counted in the clipping norm, as under the JAX
    `make_optimizer(freeze_encoder=True)`."""
    return ScheduledAdamW([p for p in params if p.requires_grad],
                          learning_rate, weight_decay, grad_clip,
                          lr_schedule(schedule, learning_rate, total_steps,
                                      warmup_steps))


def cross_entropy_loss(logits, targets):
    return F.cross_entropy(logits.float(), targets.long())


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(state: TrainState):
    """-> step(source, target, mask) -> (loss, logits), device tensors, no
    host synchronisation. One call is one optimizer update of
    `state.model` in place. A frozen model (`model.freeze`) runs the frozen
    form of either path; a model whose encoder the fused kernels cannot
    train on its device raises before any forward work
    (`check_trainable`)."""
    model, optimizer = state.model, state.optimizer

    def step(source, target, mask=None):
        optimizer.zero_grad(set_to_none=True)
        logits = mst_logits(model, source, mask, train=True)
        loss = cross_entropy_loss(logits, target)
        loss.backward()
        optimizer.update(state.step)
        state.step += 1
        return loss.detach(), logits.detach()

    return step


def make_eval_step(model):
    """Validation forward on the serving kernels -> logits [B, classes]."""

    @torch.inference_mode()
    def step(source, mask=None):
        return mst_logits(model, source, mask)

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
                 num_sanity_val_steps: int = SANITY_VAL_STEPS):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.patience = patience
        self.limit_val_batches = limit_val_batches
        self.keep_last = keep_last
        self.profile_dir = profile_dir
        self.num_sanity_val_steps = num_sanity_val_steps
        self.state_writer = TrainStateWriter()  # `last`, after every epoch

    def init_state(self, model, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2, seed: int = 0,
                   **optimizer_kw) -> TrainState:
        """Seeded random weights in the flax layout, and AdamW over them
        (over the slice fusion and head for a frozen model);
        `optimizer_kw` go to `make_optimizer` (grad_clip, schedule,
        total_steps, warmup_steps)."""
        params_from_flax(model, random_flax_params(model, seed))
        return TrainState(model, make_optimizer(
            model.parameters(), learning_rate, weight_decay, **optimizer_kw))

    def fit(self, state: TrainState, dm, hparams: Optional[Dict] = None,
            start_epoch: int = 0, resume_meta: Optional[Dict] = None) -> tuple:
        """Epochs `start_epoch` .. max_epochs - 1; a resumed run passes the
        restored state, the next epoch and `last.meta.json`'s counters."""
        model = state.model
        device = next(model.parameters()).device
        train_step = make_train_step(state)
        eval_step = make_eval_step(model)
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
