"""Train CLI of the port, the counterpart of `scripts/main_train.py`:

    python -m mst_tpu_torch.train --dataset Synthetic [--batch_size 2] \
        [--max_epochs 1000] [--num_train_samples 2000] [--patience 10] \
        [--dtype bfloat16] [--seed 0] [--lr LR] [--run_dir runs] \
        [--use_bottleneck] [--use_slice_pos_emb] [--use_registers]

It trains MST-DINOv2 ViT-S/14 on the CUDA card from seeded random weights
(pretrained weights are not in the repository) with the reference's
recipe: class-balanced weighted sampling, AdamW at the model's learning
rate, val/AUC_ROC early stopping, the top-1 checkpoint in
`<run_dir>/<dataset>/<model>_<stamp>/epoch=N/params.npz`, which
`python -m mst_tpu_torch.serve --params_npz` serves. The flags keep their
JAX names and defaults; the reference datasets (the default `LIDC` among
them) and the flags of features not ported yet are ROADMAP queue A items.
`build_model`, `build_datamodule` and `build_trainer` are split from
`main` so that tests and `chip_smoke.py` drive the CLI's own builders.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from pathlib import Path

import torch

from mst_tpu_torch.data.datamodule import DataModule, balanced_weights
from mst_tpu_torch.registry import get_dataset, get_model, model_entry
from mst_tpu_torch.train.trainer import Trainer

log = logging.getLogger(__name__)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.train")
    ap.add_argument("--dataset", default="LIDC",
                    choices=["LIDC", "DUKE", "MRNet", "Synthetic"],
                    help="only Synthetic is ported (the host data path of "
                         "the others is ROADMAP queue A #5)")
    ap.add_argument("--model", default="DinoV2ClassifierSlice")
    ap.add_argument("--run_dir", default="runs")
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--max_epochs", type=int, default=1000)
    ap.add_argument("--num_train_samples", type=int, default=2000)
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the model's default learning rate")
    ap.add_argument("--use_bottleneck", action="store_true")
    ap.add_argument("--use_slice_pos_emb", action="store_true")
    ap.add_argument("--use_registers", action="store_true")
    return ap.parse_args(argv)


def model_kwargs(args) -> dict:
    """The model options the flags set (also the run's hparams)."""
    return dict(use_bottleneck=args.use_bottleneck,
                use_slice_pos_emb=args.use_slice_pos_emb,
                num_register_tokens=4 if args.use_registers else 0)


def build_model(args):
    """-> args.model on the CUDA card in --dtype (parameters f32; the
    trainer's `init_state` draws them)."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return get_model(args.model, dtype=dtype, **model_kwargs(args)).to(
        torch.device("cuda"))


def build_datamodule(args, device, **dataset_kw) -> DataModule:
    """Train split with flip + noise augmentation and class-balanced
    weighted sampling, val split plain; `dataset_kw` go to both splits
    (e.g. `shape_cdhw`, `num_samples` of Synthetic)."""
    ds_train = get_dataset(args.dataset, split="train", flip=True,
                           noise=True, **dataset_kw)
    ds_val = get_dataset(args.dataset, split="val", **dataset_kw)
    return DataModule(ds_train=ds_train, ds_val=ds_val,
                      batch_size=args.batch_size,
                      weights=balanced_weights(ds_train.labels()),
                      num_train_samples=min(len(ds_train),
                                            args.num_train_samples),
                      seed=args.seed, device=device)


def build_trainer(args, dm, run_dir=None) -> Trainer:
    """-> Trainer in `run_dir` (default <run_dir>/<dataset>/<model>_<stamp>)."""
    if run_dir is None:
        stamp = datetime.now().strftime("%Y_%m_%d_%H%M%S")
        run_dir = Path(args.run_dir) / args.dataset / f"{args.model}_{stamp}"
    return Trainer(run_dir, max_epochs=args.max_epochs,
                   patience=args.patience,
                   limit_val_batches=min(len(dm.ds_val), 200))


def train(args, model, dm, trainer):
    """Seeded weights, AdamW at the model's (or --lr) rate, fit."""
    entry = model_entry(args.model)
    lr = entry.learning_rate if args.lr is None else args.lr
    state = trainer.init_state(model, lr, entry.weight_decay, seed=args.seed)
    hparams = {"model": args.model, "dataset": args.dataset,
               **model_kwargs(args)}
    return trainer.fit(state, dm, hparams=hparams)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    dm = build_datamodule(args, torch.device("cuda"))
    model = build_model(args)
    trainer = build_trainer(args, dm)
    _, result = train(args, model, dm, trainer)
    print(f"best val/AUC_ROC={result.best_metric:.4f} @ epoch "
          f"{result.best_epoch} ({result.epochs_run} epochs) -> "
          f"{trainer.run_dir}")
    return trainer.run_dir, result
