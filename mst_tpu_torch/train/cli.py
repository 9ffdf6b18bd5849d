"""Train CLI of the port, the counterpart of `scripts/main_train.py`:

    python -m mst_tpu_torch.train --dataset LIDC | DUKE | MRNet \
        --path_root DIR [--fold 0] [--decode_cache DIR] | --dataset Synthetic \
        [--model DinoV2ClassifierSlice | DinoV3ClassifierSlice] \
        [--model_size small | base | large | giant2] [--freeze | --remat] \
        [--patch_size P] [--pretrained_path FILE.pth] \
        [--batch_size 2] [--max_epochs 1000] [--num_train_samples 2000] [--patience 10] \
        [--dtype bfloat16] [--seed 0] [--lr LR] \
        [--lr_schedule cosine | warmup_cosine] [--run_dir runs] \
        [--resume RUN] [--profile_dir DIR] \
        [--fusion_heads 12] [--use_bottleneck] [--use_slice_pos_emb] \
        [--use_registers]

It trains MST-DINOv2 ViT-S/14 (`--model DinoV3ClassifierSlice`: MST-DINOv3
ViT-S/16 with 4 registers and 2D RoPE; `--model_size base | large |
giant2`: ViT-B/14, ViT-L/14 or the giant2 encoder with its SwiGLU FFN,
unfrozen, with `--remat` to fit ViT-L and giant2 on one card; `--freeze`:
the encoder frozen under a trained slice fusion and head) on the CUDA card
from seeded random weights, or with `--pretrained_path` from a DINOv2
(torch.hub or HuggingFace layout) or HuggingFace DINOv3 state dict, whose
encoder config (pos-embed grid, registers; for DINOv3 patch size, FFN and
RoPE) is taken from the file, as `scripts/main_train.py:194-231`. The
reference's recipe: class-balanced weighted sampling, AdamW at the
model's learning rate (`--lr_schedule`: optax's cosine or warmup-cosine
schedule), val/AUC_ROC early stopping, the top-1 checkpoint in
`<run_dir>/<dataset>/<model>_<stamp>/epoch=N/params.npz`, which
`python -m mst_tpu_torch.serve --params_npz` (DINOv2) or `--run_folder`
(any model: the run's hparams record the model's options) serves, and the
full train state in `last/`, from which `--resume RUN` continues the run in
its own folder. The reference datasets read the folder `--path_root`
(fold `--fold`; `--decode_cache DIR` or `$MST_DECODE_CACHE` keeps each
decoded volume on disk for the epochs after the first): their train split
with the reference's augmentation (flips, rotation, random centre,
inversion and noise), as `scripts/main_train.py:155-161`; the run's
hparams record the dataset, `path_root` and `fold`, so that
`python -m mst_tpu_torch.predict --run_folder RUN` scores the same
folder's test split. `--profile_dir` writes a `torch.profiler` trace of
the second epoch. The flags keep their JAX names and defaults; the flags
of features not ported yet (Adafactor, gradient accumulation, int8
training, several hosts, the other slice fusions) and an encoder whose
widths the train kernels do not take
(`DinoSliceClassifier.check_trainable`) are ROADMAP queue A items.
`build_model`, `build_datamodule`, `build_trainer` and `train` are split
from `main` so that tests and `chip_smoke.py` drive the CLI's own builders.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from pathlib import Path
from typing import Optional

import torch

from mst_tpu_torch.data.datamodule import DataModule, balanced_weights
from mst_tpu_torch.models import convert
from mst_tpu_torch.registry import get_dataset, get_model, model_entry
from mst_tpu_torch.train.trainer import Trainer
from mst_tpu_torch.utils.checkpoint import BEST_POINTER, restore_train_state

log = logging.getLogger(__name__)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.train")
    ap.add_argument("--dataset", default="LIDC",
                    choices=["LIDC", "DUKE", "MRNet", "Synthetic"])
    ap.add_argument("--path_root", default=None,
                    help="the dataset's folder (LIDC, DUKE, MRNet)")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--decode_cache", default=None, metavar="DIR",
                    help="keep each decoded volume here on its first read; "
                         "later epochs read the raw array instead of "
                         "inflating and parsing the file again (disk cost: "
                         "the decoded dataset). Also via $MST_DECODE_CACHE")
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
    ap.add_argument("--patch_size", type=int, default=None,
                    help="the encoder's patch size (model default: 14 for "
                         "DINOv2, 16 for DINOv3; taken from the state dict "
                         "with --pretrained_path)")
    ap.add_argument("--lr_schedule", default=None,
                    choices=[None, "cosine", "warmup_cosine"])
    ap.add_argument("--resume", default=None, metavar="RUN",
                    help="continue the run folder RUN from its `last` "
                         "train state (parameters, AdamW moments, update "
                         "count, early-stopping counters), in RUN")
    ap.add_argument("--pretrained_path", default=None,
                    help="a torch state dict (.pth) of the encoder: DINOv2 "
                         "in the torch.hub or HuggingFace layout, or "
                         "HuggingFace DINOv3")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of epoch 1 here")
    return ap.parse_args(argv)


def pretrained_state_dict(args) -> Optional[dict]:
    """--pretrained_path's state dict (numpy arrays), or None."""
    if not args.pretrained_path:
        return None
    return convert.load_torch_state_dict(args.pretrained_path)


def pretrained_kwargs(sd) -> dict:
    """The encoder options a pretrained state dict fixes
    (`scripts/main_train.py:194-231`): for HF DINOv3 its patch size,
    register count and FFN (kind, width), no learned pos-embed, the
    normalised 2D RoPE and LN eps 1e-5; for DINOv2 (hub or HF) its
    pos-embed grid and register count."""
    if convert.detect_encoder_layout(sd) == "hf_v3":
        cfg = convert.dinov3_config_from_sd(sd)
        return dict(patch_size=cfg["patch_size"],
                    num_register_tokens=cfg["num_register_tokens"],
                    ffn_layer=cfg["ffn_layer"], ffn_hidden=cfg["ffn_hidden"],
                    use_pos_embed=False, use_rope_2d=True,
                    rope_normalized=True, norm_eps=1e-5)
    kw = {"pos_embed_grid": convert.pos_embed_grid_from_sd(sd)}
    for key in ("register_tokens", "embeddings.register_tokens"):
        if key in sd:
            kw["num_register_tokens"] = int(sd[key].shape[1])
    return kw


def model_kwargs(args, pretrained=None) -> dict:
    """The model options the flags set, but for --model_size and
    --fusion_heads, which `build_model` passes itself. The register count
    only with --use_registers, as the JAX CLI: otherwise the model's
    default stands (0 for DINOv2, 4 for DINOv3); --patch_size where given;
    a `pretrained` state dict's config over both (`pretrained_kwargs`).
    --remat is refused for the ResNets, as `scripts/main_train.py` does."""
    if args.remat and not args.model.startswith("Dino"):
        raise SystemExit("--remat applies to the Dino ViT encoders; the "
                         "ResNet activations fit the card without it")
    kw = dict(freeze=args.freeze, remat=args.remat,
              use_bottleneck=args.use_bottleneck,
              use_slice_pos_emb=args.use_slice_pos_emb)
    if args.use_registers:
        kw["num_register_tokens"] = 4
    if args.patch_size is not None:
        kw["patch_size"] = args.patch_size
    if pretrained is not None:
        kw.update(pretrained_kwargs(pretrained))
    return kw


def build_model(args, pretrained=None, device="cuda"):
    """-> args.model at --model_size on `device` (the CUDA card) in --dtype
    (parameters f32; the trainer's `init_state` draws them), in the config
    of the `pretrained` state dict where one is given."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return get_model(args.model, model_size=args.model_size,
                     fusion_heads=args.fusion_heads, dtype=dtype,
                     **model_kwargs(args, pretrained)).to(torch.device(device))


def dataset_kwargs(args) -> dict:
    """--path_root, --fold and --decode_cache for a reference dataset
    (Synthetic takes none); a missing --path_root stops with the flag's
    name."""
    if args.dataset == "Synthetic":
        return {}
    if args.path_root is None:
        raise SystemExit(f"--dataset {args.dataset} reads its files from a "
                         f"folder: give --path_root DIR")
    return dict(path_root=args.path_root, fold=args.fold,
                decode_cache=args.decode_cache)


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
    """-> Trainer in `run_dir` (default: the --resume folder, which must
    hold `best_checkpoint.json`, else <run_dir>/<dataset>/<model>_<stamp>).
    A resumed run continues in its own folder: its restored best and
    patience counters refer to the best checkpoint there."""
    if run_dir is None and args.resume:
        run_dir = Path(args.resume)
        if not (run_dir / BEST_POINTER).exists():
            raise SystemExit(f"--resume: {run_dir} is not a run folder (no "
                             f"{BEST_POINTER})")
    if run_dir is None:
        stamp = datetime.now().strftime("%Y_%m_%d_%H%M%S")
        run_dir = Path(args.run_dir) / args.dataset / f"{args.model}_{stamp}"
    return Trainer(run_dir, max_epochs=args.max_epochs,
                   patience=args.patience,
                   limit_val_batches=min(len(dm.ds_val), 200),
                   profile_dir=args.profile_dir)


def train(args, model, dm, trainer, pretrained=None):
    """Seeded weights, the `pretrained` state dict's encoder over them
    where one is given, AdamW at the model's (or --lr) rate under
    --lr_schedule (over the slice fusion and head with --freeze); with
    --resume the `last` state of the trainer's folder over all of it;
    fit. The hparams record the model's own options (`model.config`), so
    that `serve.load_run_model` rebuilds the model that was trained, and
    the dataset's folder and fold, so that `predict` finds its test
    split."""
    entry = model_entry(args.model)
    lr = entry.learning_rate if args.lr is None else args.lr
    state = trainer.init_state(model, lr, entry.weight_decay, seed=args.seed,
                               schedule=args.lr_schedule)
    if pretrained is not None:
        enc = model.encoder
        convert.params_from_flax(model, convert.load_pretrained_encoder(
            convert.flax_params_from_torch(model), pretrained, enc.depth,
            model.ffn_layer, enc.num_heads))
        logging.getLogger(__name__).info(
            "loaded the pretrained encoder of %s", args.pretrained_path)
    start_epoch, resume_meta = 0, None
    if args.resume:
        state, resume_meta = restore_train_state(trainer.run_dir, "last",
                                                 state)
        start_epoch = int(resume_meta.get("epoch", -1)) + 1
        logging.getLogger(__name__).info(
            "resumed %s/last at update %d, next epoch %d", trainer.run_dir,
            state.step, start_epoch)
    hparams = {"model": args.model, "dataset": args.dataset,
               "path_root": (None if args.path_root is None
                             else str(Path(args.path_root).resolve())),
               "fold": args.fold, **model.config}
    return trainer.fit(state, dm, hparams=hparams, start_epoch=start_epoch,
                       resume_meta=resume_meta)


def main(argv=None, device="cuda", **dataset_kw):
    """Run the CLI; `device` and `dataset_kw` (see `build_datamodule`) are
    for tests, which train on the CPU."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    dm = build_datamodule(args, torch.device(device), **dataset_kw)
    pretrained = pretrained_state_dict(args)
    model = build_model(args, pretrained, device)
    trainer = build_trainer(args, dm)
    _, result = train(args, model, dm, trainer, pretrained)
    print(f"best val/AUC_ROC={result.best_metric:.4f} @ epoch "
          f"{result.best_epoch} ({result.epochs_run} epochs) -> "
          f"{trainer.run_dir}")
    return trainer.run_dir, result
