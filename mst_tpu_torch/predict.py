"""Predict CLI of the port, the counterpart of `scripts/main_predict.py`:

    python -m mst_tpu_torch.predict --run_folder RUN [--path_root DIR] \
        [--decode_cache DIR] [--output_dir DIR] \
        [--use_tta] [--use_rollout [--rollout_abnar]] [--save_saliency] \
        [--get_segmentation] [--get_attention] [--ensemble RUN ...] \
        [--batch_size 1] [--dtype bfloat16] [--int8 [--int8_calib N]]

It scores the test split of the run's dataset (LIDC, DUKE and MRNet from
the run's `path_root` and `fold`, or `--path_root`; `--decode_cache` as
the train CLI's) with the run's best
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
  & Zuidema rollout with `--rollout_abnar` too;
- with `--get_segmentation` (`:327-333, 374-388`), the saliency thresholded
  at its 0.999 quantile against the voxels where at least two raters agree
  (`rater_masks`, the LIDC test split's and Synthetic's): `results_seg.csv`
  (`uid, GT, NN, Dice, IoU, ASSD`, the ASSD in the case's spacing) and a
  mean ± std line per metric in the log; a case without rater masks is
  skipped, in `results.csv` too; with `--save_saliency` also
  `case_<uid>/seg.nii.gz` (uint8);
- with `--get_attention` (`:418-424`), for each positive case,
  `case_<uid>/input.png` (the slice grid), `attention.png` (the saliency
  over it in the jet colormap) and, where the batch has a mask,
  `ground_truth.png` (`utils/functions.py`: numpy and zlib, no
  matplotlib).

Saliency modes (`--save_saliency`, `--get_segmentation`,
`--get_attention`) run one case per batch, as the reference does.
`--ensemble RUN ...` (`:171-217, 334-356`) scores with this run and every
RUN: the members' probabilities are averaged after the softmax, and each
member's saliency map is divided by its largest magnitude before the mean;
a member whose parameters differ in name or shape stops the CLI, and a
member trained on another fold, or one that records none, is logged.

Slices above 512 tokens (e.g. 518 px) are scored on the composed path
with the flash kernels, and their saliency on it too (the CLS-row, carry
or Abnar kernel on the flash forward's LSE; an int8 model raises there,
as in JAX).
`--use_tta` averages the 8 flips of each case, run as one batch. `--int8`
runs every member's encoder on the W8A8 kernels (`ops/fused_int8.py`) with
per-token activation scales, `--int8_calib N` with static ones calibrated
on the first N test volumes as served (`quantize_model`, the same volumes
for every member), in every mode. `roc.png` and `confusion_matrix.png`
need matplotlib and seaborn and are not written (the log has their
numbers); `--num_devices` and `--distributed` stop with the ROADMAP item
that brings them. `build_model`, `build_members`, `build_datamodule` and
`predict_cases` are split from `main` so that tests and `chip_smoke.py`
drive the CLI's own builders.
"""

from __future__ import annotations

import argparse
import csv
import logging
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.registry import get_dataset
from mst_tpu_torch.serve import load_run_model
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.utils.checkpoint import BEST_POINTER, load_hparams
from mst_tpu_torch.utils.functions import (
    overlay_cam,
    overlay_mask,
    tensor2image,
)
from mst_tpu_torch.utils.metrics import (
    binary_auroc,
    cm2acc,
    cm2x,
    confusion_matrix,
    youden_working_point,
)
from mst_tpu_torch.utils.nifti import write_nifti
from mst_tpu_torch.utils.seg_metrics import (
    average_surface_distance,
    dice_score,
    iou_score,
    saliency_to_mask,
)

log = logging.getLogger(__name__)

_LATER = {
    "num_devices": "ROADMAP queue A #13",
    "distributed": "ROADMAP queue A #13",
}
RESULT_COLUMNS = ("uid", "GT", "NN", "NN_pred")
SEG_COLUMNS = ("uid", "GT", "NN", "Dice", "IoU", "ASSD")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.predict")
    ap.add_argument("--run_folder", required=True)
    ap.add_argument("--path_root", default=None,
                    help="the dataset's folder (default: the run's)")
    ap.add_argument("--decode_cache", default=None, metavar="DIR",
                    help="decoded-volume disk cache shared with the train "
                         "CLI (see its --help); also via $MST_DECODE_CACHE")
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
                    help="write case_<uid>/saliency.nii.gz and input.nii.gz "
                         "(and seg.nii.gz with --get_segmentation)")
    ap.add_argument("--batch_size", type=int, default=1,
                    help="volumes per forward without saliency (saliency "
                         "modes run one case per batch)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="compute dtype (the CUDA kernels take bfloat16)")
    ap.add_argument("--get_attention", action="store_true",
                    help="write input.png, attention.png and "
                         "ground_truth.png for each positive case")
    ap.add_argument("--get_segmentation", action="store_true",
                    help="score the saliency's 0.999-quantile mask against "
                         "the >= 2-rater ground truth: results_seg.csv "
                         "(Dice, IoU, ASSD)")
    ap.add_argument("--ensemble", nargs="+", default=None, metavar="RUN_DIR",
                    help="more run folders of the same architecture: "
                         "probabilities (and max-normalised saliency maps) "
                         "averaged over this run and them. On datasets "
                         "whose test split rotates with the fold (LIDC, "
                         "DUKE) a cross-fold ensemble leaks: member fold k "
                         "trained on this fold's test cases. Every member "
                         "stays on the card")
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


def wants_saliency(args) -> bool:
    """Whether the run needs saliency maps (`main_predict.py:224`)."""
    return bool(args.get_attention or args.get_segmentation
                or args.save_saliency)


def plane_mode(args) -> str:
    if not args.use_rollout:
        return "last"
    return "rollout_abnar" if args.rollout_abnar else "rollout"


def build_model(args, device):
    """-> the run's model with its best checkpoint, on `device`."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return load_run_model(args.run_folder, dtype).to(device).eval()


def _param_shapes(model) -> list:
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


def build_members(args, device) -> list:
    """-> [the run's model, each --ensemble member's] on `device`. A member
    must be a run folder whose parameters match the run's in name and
    shape, else SystemExit; a member trained on another fold, or a run
    without a recorded fold, is logged (`main_predict.py:171-217`)."""
    models = [build_model(args, device)]
    if not args.ensemble:
        return models
    run = Path(args.run_folder)
    want = _param_shapes(models[0])
    fold = (load_hparams(run) or {}).get("fold")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    for member in map(Path, args.ensemble):
        if not (member / BEST_POINTER).exists():
            raise SystemExit(f"--ensemble: {member} is not a run folder (no "
                             f"{BEST_POINTER})")
        model = load_run_model(member, dtype)
        if _param_shapes(model) != want:
            raise SystemExit(f"--ensemble: {member} has a different "
                             f"architecture (param tree mismatch)")
        mfold = (load_hparams(member) or {}).get("fold")
        if mfold is None or fold is None:
            log.info("--ensemble: fold not recorded for %s — cannot verify "
                     "the members trained on the same split",
                     member if mfold is None else run)
        elif mfold != fold:
            log.warning("--ensemble member %s trained on fold %d (this run: "
                        "fold %d) — leaks on rotating-test datasets, see "
                        "--help", member, mfold, fold)
        models.append(model.to(device).eval())
    log.info("ensemble of %d models", len(models))
    return models


def calibration_source(args, dm):
    """--int8_calib N: the first N test volumes as the loader serves them
    (`scripts/main_predict.py:287-321`), else None."""
    if args.int8_calib <= 0:
        return None
    vols = []
    for batch in dm.test_dataloader():
        vols.append(torch.as_tensor(batch["source"]))
        if sum(len(v) for v in vols) >= args.int8_calib:
            break
    return torch.cat(vols)[:args.int8_calib]


def quantize_model(args, model, dm, calib=None):
    """--int8: a copy of `model` with its encoder quantized to W8A8; with
    --int8_calib N the static scales are calibrated on `calib`, by default
    the first N test volumes as served (`calibration_source`)."""
    from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8

    if calib is None:
        calib = calibration_source(args, dm)
    return quantize_mst_int8(model, calib)


def quantize_members(args, models, dm) -> list:
    """--int8: every member quantized, calibrated on the same volumes."""
    calib = calibration_source(args, dm)
    return [quantize_model(args, m, dm, calib) for m in models]


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
                          decode_cache=args.decode_cache, **dataset_kw)
    ds = get_dataset(name, split="test", **dataset_kw)
    batch_size = 1 if wants_saliency(args) else max(1, args.batch_size)
    return DataModule(ds_test=ds, batch_size=batch_size, device=device)


def spacing_dhw(batch) -> np.ndarray:
    """The first case's voxel spacing in (D, H, W) order: its
    `spacing_dhw`, else its affine's diagonal reversed, else 1
    (`scripts/main_predict.py:374-388, 395-405`)."""
    if "spacing_dhw" in batch:
        return np.asarray(batch["spacing_dhw"][0], float)
    if "affine" in batch:
        return np.abs(np.diag(np.asarray(batch["affine"][0]))[:3])[::-1]
    return np.ones(3)


def spacing_xyz(batch) -> list:
    """The first case's voxel spacing in NIfTI (x, y, z) order."""
    sp = spacing_dhw(batch)
    return [float(sp[2]), float(sp[1]), float(sp[0])]


@contextmanager
def _timed(times, key):
    """Adds the block's wall seconds to times[key] (`times` None: no-op)."""
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    times[key] = times.get(key, 0.0) + time.perf_counter() - t0


def ensemble_predict(fns, source, mask):
    """Each member's predict fn on the batch -> (probs, saliency | None):
    one member's as they are, else the probabilities' mean (in f64, so
    that a member repeated k times gives its own probabilities back) and
    the mean of the saliency maps, each divided by its volume's largest
    magnitude (at least 1e-12) first, as `main_predict.py:334-356`."""
    outs = [fn(source, mask) for fn in fns]
    if len(outs) == 1:
        return outs[0]
    probs = torch.stack([p for p, _ in outs]).double().mean(0).float()
    sals = [s for _, s in outs if s is not None]
    if not sals:
        return probs, None
    dims = tuple(range(1, sals[0].ndim))
    return probs, torch.stack(
        [s / s.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
         for s in sals]).mean(0)


def predict_cases(args, models, dm, out_dir: Path, times=None):
    """Score every test case with the members `models` (`build_members`)
    -> (result rows, segmentation rows); write each case's NIfTIs and PNGs
    as the flags ask. `times` (a dict) collects the wall seconds of the
    forwards, the segmentation scores, the NIfTI and the PNG writes."""
    want_sal = wants_saliency(args)
    fns = [make_predict_fn(m, tta=args.use_tta, with_saliency=want_sal,
                           plane_mode=plane_mode(args)) for m in models]
    rows, seg_rows = [], []
    for batch in dm.test_dataloader():
        rater_masks = batch.get("rater_masks", [None])[0]
        if args.get_segmentation and rater_masks is None:
            continue  # no multi-rater ground truth (`main_predict.py:235`)
        with _timed(times, "forward"):
            probs, sal = ensemble_predict(
                fns, batch["source"], batch.get("src_key_padding_mask"))
            probs = probs.float().cpu().numpy()
            if sal is not None:  # one case per batch
                sal = sal[0].float().cpu().numpy()
        for i, uid in enumerate(batch["uid"]):
            rows.append({"uid": uid, "GT": int(batch["target"][i]),
                         "NN": int(probs[i].argmax()),
                         "NN_pred": float(probs[i, 1])})
        if sal is None:
            continue
        uid, target = batch["uid"][0], int(batch["target"][0])
        case_dir = out_dir / f"case_{uid}"
        seg = None
        if args.get_segmentation:
            with _timed(times, "segmentation"):
                # >= 2 raters agree -> ground truth (reference :243-250)
                gt = np.asarray(rater_masks)[:, 0].sum(0) >= 2
                seg = saliency_to_mask(sal, 0.999)
                seg_rows.append({
                    "uid": uid, "GT": target, "NN": int(probs[0].argmax()),
                    "Dice": dice_score(seg, gt), "IoU": iou_score(seg, gt),
                    "ASSD": average_surface_distance(
                        seg, gt, spacing=spacing_dhw(batch))})
        if args.save_saliency:
            with _timed(times, "nifti"):
                # NIfTI (x, y, z) order; a spacing-only affine (the crop's
                # grid has no origin to keep)
                aff = np.diag([*spacing_xyz(batch), 1.0])
                vols = [("saliency.nii.gz", sal), ("input.nii.gz", batch[
                    "source"][0, 0].float().cpu().numpy())]
                if seg is not None:
                    vols.append(("seg.nii.gz", seg.astype(np.uint8)))
                for fname, vol in vols:
                    write_nifti(case_dir / fname,
                                np.transpose(vol, (2, 1, 0)), aff)
        if args.get_attention and target == 1:
            with _timed(times, "png"):
                src = batch["source"][:1].float().cpu().numpy()
                tensor2image(src, case_dir / "input.png")
                overlay_cam(src, sal, case_dir / "attention.png")
                if "mask" in batch:
                    overlay_mask(src, torch.as_tensor(
                        batch["mask"][:1]).cpu().numpy(),
                        case_dir / "ground_truth.png")
    return rows, seg_rows


def write_results(rows, out_dir: Path, seg_rows=()) -> None:
    """results.csv (and results_seg.csv), and the metrics into the log
    (predict.log)."""
    with (out_dir / "results.csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=RESULT_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    if seg_rows:
        with (out_dir / "results_seg.csv").open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=SEG_COLUMNS)
            writer.writeheader()
            # NaN as an empty field, as pandas writes it
            writer.writerows({k: "" if isinstance(v, float) and np.isnan(v)
                              else v for k, v in r.items()}
                             for r in seg_rows)
        for m in ("Dice", "IoU", "ASSD"):
            vals = np.array([r[m] for r in seg_rows], float)
            log.info("%s: %.4f ± %.4f", m, np.nanmean(vals), np.nanstd(vals))
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


def main(argv=None, device="cuda", times=None, **dataset_kw):
    """Run the CLI; `device`, `times` (see `predict_cases`) and `dataset_kw`
    (see `build_datamodule`) are for in-process use. Returns the output
    directory."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    run = Path(args.run_folder)
    out_dir = Path(args.output_dir) if args.output_dir else run / "results"
    out_dir.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(out_dir / "predict.log")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        models = build_members(args, torch.device(device))
        dm = build_datamodule(args, torch.device(device), **dataset_kw)
        if args.int8:
            models = quantize_members(args, models, dm)
        rows, seg_rows = predict_cases(args, models, dm, out_dir, times)
        write_results(rows, out_dir, seg_rows)
    finally:
        log.removeHandler(handler)
        handler.close()
    return out_dir


if __name__ == "__main__":
    main()
