"""Train CLI of the port, the counterpart of `scripts/main_train.py`:

    python -m mst_tpu_torch.train --dataset LIDC | DUKE | MRNet \
        --path_root DIR [--fold 0] | --dataset Synthetic \
        [--model DinoV2ClassifierSlice | DinoV3ClassifierSlice] \
        [--model_size small | base | large | giant2] [--freeze | --remat] \
        [--batch_size 2] [--max_epochs 1000] [--num_train_samples 2000] [--patience 10] \
        [--dtype bfloat16] [--seed 0] [--lr LR] [--run_dir runs] \
        [--fusion_heads 12] [--use_bottleneck] [--use_slice_pos_emb] \
        [--use_registers]

It trains MST-DINOv2 ViT-S/14 (`--model DinoV3ClassifierSlice`: MST-DINOv3
ViT-S/16 with 4 registers and 2D RoPE; `--model_size base | large |
giant2`: ViT-B/14, ViT-L/14 or the giant2 encoder with its SwiGLU FFN,
unfrozen, with `--remat` to fit ViT-L and giant2 on one card; `--freeze`:
the encoder frozen under a trained slice fusion and head) on the CUDA card
from seeded random weights (pretrained weights are not in the repository)
with the reference's recipe: class-balanced weighted sampling, AdamW at the
model's learning rate, val/AUC_ROC early stopping, the top-1 checkpoint in
`<run_dir>/<dataset>/<model>_<stamp>/epoch=N/params.npz`, which
`python -m mst_tpu_torch.serve --params_npz` (DINOv2) or `--run_folder`
(any model: the run's hparams record the model's options) serves. The
reference datasets read the folder `--path_root` (fold `--fold`): their
train split with the reference's augmentation (flips, rotation, random
centre, inversion and noise), as `scripts/main_train.py:155-161`; the
run's hparams record the dataset, `path_root` and `fold`, so that
`python -m mst_tpu_torch.predict --run_folder RUN` scores the same
folder's test split. The flags keep their JAX names and defaults; the
flags of features not ported yet (Adafactor, gradient accumulation, the
disk decode cache) and an encoder whose widths the train kernels do not
take (`DinoSliceClassifier.check_trainable`) are ROADMAP queue A items.
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
                    choices=["LIDC", "DUKE", "MRNet", "Synthetic"])
    ap.add_argument("--path_root", default=None,
                    help="the dataset's folder (LIDC, DUKE, MRNet)")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--model", default="DinoV2ClassifierSlice")
    ap.add_argument("--model_size", default="small",
                    help="small | base | large | giant2 (SwiGLU FFN)")
    ap.add_argument("--freeze", action="store_true",
                    help="train the slice fusion and head on a frozen "
                         "encoder (the encoder runs on the serving kernels)")
    ap.add_argument("--remat", action="store_true",
                    help="per-block gradient rematerialisation "
                         "(torch.utils.checkpoint): the backward recomputes "
                         "each encoder block instead of storing its "
                         "residuals, so that unfrozen ViT-L and giant2 fit "
                         "one card")
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
    ap.add_argument("--fusion_heads", type=int, default=12,
                    help="heads of the slice-fusion layer; they must divide "
                         "its width (ViT-L's 1024: e.g. 16)")
    ap.add_argument("--use_bottleneck", action="store_true")
    ap.add_argument("--use_slice_pos_emb", action="store_true")
    ap.add_argument("--use_registers", action="store_true")
    return ap.parse_args(argv)


def model_kwargs(args) -> dict:
    """The model options the flags set, but for --model_size and
    --fusion_heads, which `build_model` passes itself. The register count only with
    --use_registers, as the JAX CLI: otherwise the model's default stands
    (0 for DINOv2, 4 for DINOv3). --remat is refused for the ResNets, as
    `scripts/main_train.py` does."""
    if args.remat and not args.model.startswith("Dino"):
        raise SystemExit("--remat applies to the Dino ViT encoders; the "
                         "ResNet activations fit the card without it")
    kw = dict(freeze=args.freeze, remat=args.remat,
              use_bottleneck=args.use_bottleneck,
              use_slice_pos_emb=args.use_slice_pos_emb)
    if args.use_registers:
        kw["num_register_tokens"] = 4
    return kw


def build_model(args):
    """-> args.model at --model_size on the CUDA card in --dtype
    (parameters f32; the trainer's `init_state` draws them)."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return get_model(args.model, model_size=args.model_size,
                     fusion_heads=args.fusion_heads, dtype=dtype,
                     **model_kwargs(args)).to(torch.device("cuda"))


def dataset_kwargs(args) -> dict:
    """--path_root and --fold for a reference dataset (Synthetic takes
    neither); a missing --path_root stops with the flag's name."""
    if args.dataset == "Synthetic":
        return {}
    if args.path_root is None:
        raise SystemExit(f"--dataset {args.dataset} reads its files from a "
                         f"folder: give --path_root DIR")
    return dict(path_root=args.path_root, fold=args.fold)


def build_datamodule(args, device, **dataset_kw) -> DataModule:
    """Train split with the reference's augmentation (flips, z-rotation,
    random centre, inversion and noise) and class-balanced weighted
    sampling, val split plain; `dataset_kw` go to both splits (e.g.
    `shape_cdhw`, `num_samples` of Synthetic)."""
    dataset_kw = {**dataset_kwargs(args), **dataset_kw}
    ds_train = get_dataset(args.dataset, split="train", flip=True,
                           noise=True, random_center=True,
                           random_rotate=True, **dataset_kw)
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
    """Seeded weights, AdamW at the model's (or --lr) rate (over the slice
    fusion and head with --freeze), fit. The hparams record the model's own options (`model.config`), so that
    `serve.load_run_model` rebuilds the model that was trained, and the
    dataset's folder and fold, so that `predict` finds its test split."""
    entry = model_entry(args.model)
    lr = entry.learning_rate if args.lr is None else args.lr
    state = trainer.init_state(model, lr, entry.weight_decay, seed=args.seed)
    hparams = {"model": args.model, "dataset": args.dataset,
               "path_root": (None if args.path_root is None
                             else str(Path(args.path_root).resolve())),
               "fold": args.fold, **model.config}
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
