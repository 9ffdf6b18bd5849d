"""Predict CLI of the port, the counterpart of `scripts/main_predict.py`:

    python -m mst_tpu_torch.predict --run_folder RUN [--path_root DIR] \
        [--output_dir DIR] \
        [--use_tta] [--use_rollout [--rollout_abnar]] [--save_saliency] \
        [--batch_size 1] [--dtype bfloat16] [--int8 [--int8_calib N]]

It scores the test split of the run's dataset (LIDC, DUKE and MRNet from
the run's `path_root` and `fold`, or `--path_root`) with the run's best
checkpoint (`serve.load_run_model`) on the CUDA card and writes, under
`--output_dir` (default `<RUN>/results`):

- `results.csv`: `uid, GT, NN, NN_pred` per case (NN the argmax class,
  NN_pred the class-1 probability);
- `predict.log`: the AUC, the argmax accuracy and confusion matrix, and
  the accuracy, PPV, NPV, sensitivity and specificity at the Youden point
  of the ROC curve;
- with `--save_saliency`, `case_<uid>/saliency.nii.gz` and `input.nii.gz`
  (NIfTI (x, y, z) order, the case's voxel spacing on the affine's
  diagonal, as `scripts/main_predict.py:395-405`): the saliency map of the
  fused explainability forward, the last block's CLS attention by default,
  the reference `get_attention_cls` rollout with `--use_rollout`, the Abnar
  & Zuidema rollout with `--rollout_abnar` too. Saliency modes run one
  case per batch, as the reference does.

Slices above 512 tokens (e.g. 518 px) are scored on the composed path
with the flash kernels; their saliency (`--save_saliency`) is ROADMAP queue
A #16 and raises. `--use_tta` averages the 8 flips of each case, run as
one batch. `--int8`
runs the encoder on the W8A8 kernels (`ops/fused_int8.py`) with per-token
activation scales, `--int8_calib N` with static ones calibrated on the
first N test volumes as served (`quantize_model`), in every mode. The other
flags of `scripts/main_predict.py` stop with the ROADMAP item that brings
them. `build_model`, `build_datamodule` and `predict_cases` are split from
`main` so that tests and `chip_smoke.py` drive the CLI's own builders.
"""

from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path

import numpy as np
import torch

from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.registry import get_dataset
from mst_tpu_torch.serve import load_run_model
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.utils.checkpoint import load_hparams
from mst_tpu_torch.utils.metrics import (
    binary_auroc,
    cm2acc,
    cm2x,
    confusion_matrix,
    youden_working_point,
)
from mst_tpu_torch.utils.nifti import write_nifti

log = logging.getLogger(__name__)

_LATER = {
    "get_attention": "PNG overlays need matplotlib and seaborn, which the "
                     "card's machine lacks (ROADMAP queue A #6)",
    "get_segmentation": "the Dice / IoU / ASSD scores against the LIDC "
                        "rater masks (ROADMAP queue A #6)",
    "ensemble": "ROADMAP queue A #6",
    "num_devices": "ROADMAP queue A #13",
    "distributed": "ROADMAP queue A #13",
}
RESULT_COLUMNS = ("uid", "GT", "NN", "NN_pred")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.predict")
    ap.add_argument("--run_folder", required=True)
    ap.add_argument("--path_root", default=None,
                    help="the dataset's folder (default: the run's)")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--use_tta", action="store_true",
                    help="average the 8 flips of each case (one batch)")
    ap.add_argument("--use_rollout", action="store_true",
                    help="saliency from the attention rollout over all ViT "
                         "blocks (the reference get_attention_cls chain) "
                         "instead of the last block's CLS row")
    ap.add_argument("--rollout_abnar", action="store_true",
                    help="with --use_rollout: the Abnar & Zuidema rollout "
                         "(identity residual + row norm) instead")
    ap.add_argument("--save_saliency", action="store_true",
                    help="write case_<uid>/saliency.nii.gz and input.nii.gz")
    ap.add_argument("--batch_size", type=int, default=1,
                    help="volumes per forward without saliency (saliency "
                         "modes run one case per batch)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="compute dtype (the CUDA kernels take bfloat16)")
    ap.add_argument("--get_attention", action="store_true")
    ap.add_argument("--get_segmentation", action="store_true")
    ap.add_argument("--ensemble", nargs="+", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="serve the encoder on the W8A8 int8 kernels "
                         "(per-token activation scales)")
    ap.add_argument("--int8_calib", type=int, default=0, metavar="N",
                    help="with --int8: calibrate static activation scales "
                         "on the first N test volumes as served and fold "
                         "them in (0: per-token scales)")
    ap.add_argument("--num_devices", type=int, default=1)
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        val = getattr(args, flag)
        if val and not (flag == "num_devices" and val == 1):
            ap.error(f"--{flag}: not ported to mst_tpu_torch yet ({why})")
    if args.int8_calib and not args.int8:
        ap.error("--int8_calib N needs --int8")
    return args


def plane_mode(args) -> str:
    if not args.use_rollout:
        return "last"
    return "rollout_abnar" if args.rollout_abnar else "rollout"


def build_model(args, device):
    """-> the run's model with its best checkpoint, on `device`."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return load_run_model(args.run_folder, dtype).to(device).eval()


def quantize_model(args, model, dm):
    """--int8: a copy of `model` with its encoder quantized to W8A8; with
    --int8_calib N the static scales are calibrated on the first N test
    volumes as the loader serves them (`scripts/main_predict.py:287-321`)."""
    from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8

    calib = None
    if args.int8_calib > 0:
        vols = []
        for batch in dm.test_dataloader():
            vols.append(torch.as_tensor(batch["source"]))
            if sum(len(v) for v in vols) >= args.int8_calib:
                break
        calib = torch.cat(vols)[:args.int8_calib]
    return quantize_mst_int8(model, calib)


def build_datamodule(args, device, **dataset_kw) -> DataModule:
    """The test split of the run's dataset (its hparams' `dataset`, else the
    run folder's parent name), a reference dataset's from --path_root or
    the run's `path_root`, in the run's fold; `dataset_kw` go to the
    dataset (e.g. `shape_cdhw`, `num_samples` of Synthetic)."""
    run = Path(args.run_folder)
    hparams = load_hparams(run) or {}
    name = hparams.get("dataset") or run.parent.name
    if name != "Synthetic":
        root = args.path_root or hparams.get("path_root")
        if root is None:
            raise SystemExit(f"the run's dataset {name} reads its files from "
                             f"a folder: give --path_root DIR")
        dataset_kw = dict(path_root=root, fold=hparams.get("fold", 0),
                          **dataset_kw)
    ds = get_dataset(name, split="test", **dataset_kw)
    batch_size = 1 if args.save_saliency else max(1, args.batch_size)
    return DataModule(ds_test=ds, batch_size=batch_size, device=device)


def spacing_xyz(batch) -> list:
    """The first case's voxel spacing in NIfTI (x, y, z) order: its
    `spacing_dhw` reversed, else its affine's diagonal, else 1
    (`scripts/main_predict.py:395-405`)."""
    if "spacing_dhw" in batch:
        sp = np.asarray(batch["spacing_dhw"][0], float)
    elif "affine" in batch:
        sp = np.abs(np.diag(np.asarray(batch["affine"][0]))[:3])[::-1]
    else:
        sp = np.ones(3)
    return [float(sp[2]), float(sp[1]), float(sp[0])]


def predict_cases(args, model, dm, out_dir: Path) -> list:
    """Score every test case -> result rows; with --save_saliency write
    each case's saliency and input volumes."""
    predict = make_predict_fn(model, tta=args.use_tta,
                              with_saliency=args.save_saliency,
                              plane_mode=plane_mode(args))
    rows = []
    for batch in dm.test_dataloader():
        probs, sal = predict(batch["source"],
                             batch.get("src_key_padding_mask"))
        probs = probs.float().cpu().numpy()
        for i, uid in enumerate(batch["uid"]):
            rows.append({"uid": uid, "GT": int(batch["target"][i]),
                         "NN": int(probs[i].argmax()),
                         "NN_pred": float(probs[i, 1])})
        if sal is not None:  # one case per batch
            # NIfTI (x, y, z) order; a spacing-only affine (the crop's grid
            # has no origin to keep)
            case_dir = out_dir / f"case_{batch['uid'][0]}"
            aff = np.diag([*spacing_xyz(batch), 1.0])
            for fname, vol in (("saliency.nii.gz", sal[0]),
                               ("input.nii.gz", batch["source"][0, 0])):
                write_nifti(case_dir / fname, np.transpose(
                    vol.float().cpu().numpy(), (2, 1, 0)), aff)
    return rows


def write_results(rows, out_dir: Path) -> None:
    """results.csv, and the metrics into the log (predict.log)."""
    with (out_dir / "results.csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=RESULT_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    gt = np.array([r["GT"] for r in rows], int)
    if len(set(gt.tolist())) < 2:
        log.info("%d cases, one class: no AUC or working point", len(rows))
        return
    score = np.array([r["NN_pred"] for r in rows])
    cm_arg = confusion_matrix([r["NN"] for r in rows], gt)
    log.info("AUC=%.4f (%d cases)", binary_auroc(score, gt), len(rows))
    log.info("argmax ACC=%.4f  CM=%s", cm2acc(cm_arg), cm_arg.tolist())
    thr, cm = youden_working_point(gt, score)
    ppv, npv, sens, spec = cm2x(cm)
    log.info("Youden point NN_pred >= %.6g: ACC=%.4f  Sens=%.4f Spec=%.4f "
             "PPV=%.4f NPV=%.4f  CM=%s", thr, cm2acc(cm), sens, spec, ppv,
             npv, cm.tolist())


def main(argv=None, device="cuda", **dataset_kw):
    """Run the CLI; `device` and `dataset_kw` (see `build_datamodule`) are
    for in-process use. Returns the output directory."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    run = Path(args.run_folder)
    out_dir = Path(args.output_dir) if args.output_dir else run / "results"
    out_dir.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(out_dir / "predict.log")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        model = build_model(args, torch.device(device))
        dm = build_datamodule(args, torch.device(device), **dataset_kw)
        if args.int8:
            model = quantize_model(args, model, dm)
        write_results(predict_cases(args, model, dm, out_dir), out_dir)
    finally:
        log.removeHandler(handler)
        handler.close()
    return out_dir


if __name__ == "__main__":
    main()
