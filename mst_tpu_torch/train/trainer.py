"""Training loop: the fused train step, val-AUC early stopping, top-1
checkpoints.

Counterpart of `mst_tpu/train/trainer.py` on one card, for the fused path
(`make_train_step` of the standard DinoSliceClassifier configuration):

- the step runs `fused_mst_logits(train=True)` (blocks 0-10 on the
  residual-saving sub-layers, whose backward is a chain of hand-written
  kernels), CE in f32, `loss.backward()`, and an AdamW update set up as
  optax `adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on
  every parameter, constant learning rate);
- the eval step runs the serving forward under `torch.inference_mode()`;
- `Trainer.fit` runs sanity val steps, the epoch loop (per-step results
  drained to the host every 64 steps, so no step waits for the card),
  midrank AUC on the validation split, `history.jsonl` with the JAX keys
  (including `perf/*` from `utils.profiling.StepTimer`), the top-1
  `epoch=N/` checkpoint with `best_checkpoint.json`, and early stopping
  with patience and `min_epochs`.

LR schedules, grad clipping, Adafactor, gradient accumulation, frozen
encoders, `--remat` and the resumable `last` state are later ROADMAP items
(queue A #4's remainder).
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.vit_fast import fused_mst_logits
from mst_tpu_torch.utils.checkpoint import save_best_checkpoint, save_checkpoint
from mst_tpu_torch.utils.metrics import ClassificationMetrics
from mst_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger(__name__)

MONITOR = "AUC_ROC"  # val metric of early stopping and the best checkpoint
SANITY_VAL_STEPS = 2  # Lightning's num_sanity_val_steps (reference default)
DRAIN_EVERY = 64  # steps whose results wait on the card before a host read


def make_optimizer(params, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """optax `adamw(learning_rate, weight_decay=weight_decay)`: one group,
    so the decay reaches every parameter (optax masks no leaf: biases, LN,
    LayerScale and the tokens decay too). PyTorch's default implementation;
    the update is the same algebra: p -= lr * (m^ / (sqrt(v^) + eps) + wd * p)."""
    return torch.optim.AdamW(list(params), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


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
    `state.model` in place."""
    model, optimizer = state.model, state.optimizer

    def step(source, target, mask=None):
        optimizer.zero_grad(set_to_none=True)
        logits = fused_mst_logits(model, source, mask, train=True)
        loss = cross_entropy_loss(logits, target)
        loss.backward()
        optimizer.step()
        state.step += 1
        return loss.detach(), logits.detach()

    return step


def make_eval_step(model):
    """Validation forward on the serving kernels -> logits [B, classes]."""

    @torch.inference_mode()
    def step(source, mask=None):
        return fused_mst_logits(model, source, mask)

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
                 patience: int = 10, limit_val_batches: Optional[int] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.max_epochs = max_epochs
        self.min_epochs = min_epochs
        self.patience = patience
        self.limit_val_batches = limit_val_batches

    def init_state(self, model, learning_rate: float = 1e-6,
                   weight_decay: float = 1e-2, seed: int = 0) -> TrainState:
        """Seeded random weights in the flax layout (pretrained weights are
        not in the repository), and AdamW over them."""
        params_from_flax(model, random_flax_params(model, seed))
        return TrainState(model, make_optimizer(model.parameters(),
                                                learning_rate, weight_decay))

    def fit(self, state: TrainState, dm,
            hparams: Optional[Dict] = None) -> tuple:
        model = state.model
        device = next(model.parameters()).device
        train_step = make_train_step(state)
        eval_step = make_eval_step(model)
        best, best_epoch, stale = -np.inf, -1, 0
        history = []

        def target_of(batch):
            return torch.from_numpy(batch["target"]).to(device, torch.long)

        # Lightning's sanity check (reference `num_sanity_val_steps=2`): an
        # eval-path fault fails in seconds, not after the first epoch.
        for bi, batch in enumerate(dm.val_dataloader()):
            if bi >= SANITY_VAL_STEPS:
                break
            eval_step(batch["source"])

        timer = StepTimer()
        for epoch in range(self.max_epochs):
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

            for batch in dm.train_dataloader():
                with timer.step():
                    loss, logits = train_step(batch["source"],
                                              target_of(batch))
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
                logits = eval_step(batch["source"])
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
            if epoch + 1 >= self.min_epochs and stale >= self.patience:
                log.info("early stopping at epoch %d (best %.4f @ %d)",
                         epoch, best, best_epoch)
                break
        return state, FitResult(float(best), best_epoch, len(history),
                                history)
