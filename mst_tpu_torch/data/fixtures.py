"""Small dataset folders in the reference datasets' layouts, made from a
seed, for the tests and `chip_smoke.py` (the real datasets are not in the
repository).

- `write_lidc`: `preprocessed/splits/split.csv` and, per nodule,
  `preprocessed_crop/data/<patient>/<study>/<series>/img_{n}.nii.gz` (int16
  HU, the (256, 256, 32) crops of `scripts/preprocessing/lidc/
  step4_crop_or_pad.py`), `seg_{n}.nii.gz` (a nodule ball) and, per rater,
  `seg_{n}_{r}.nii.gz`.
- `write_mrnet`: `preprocessed/splits/split.csv` and the sagittal stacks
  `preprocessed/data/train/sagittal/{ID:04d}.nii.gz` ([S, H, W] as
  `scripts/preprocessing/mrnet/step1_npy2nifti.py` writes them).
- `duke_arrays`: the seeded arrays of the committed DUKE fixture,
  `tests/fixtures/duke/` (`data_compressed.h5` with gzip + shuffle chunks,
  written by h5py from these arrays, and `splits/split.csv`), for checking
  what a reader returns.

Each split.csv puts its rows in `splits` order: every `n // len(splits)`
consecutive cases share a split, the last block takes the remainder.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from mst_tpu_torch.utils.nifti import write_nifti

DUKE_FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "duke"
DUKE_SEED = 20
DUKE_CASES = 10
DUKE_SHAPE = (1, 32, 28, 10)  # [C, W, H, D] as the h5 pack stores it


def _splits(n: int, splits) -> list:
    per = max(1, n // len(splits))
    return [splits[min(i // per, len(splits) - 1)] for i in range(n)]


def _write_csv(path: Path, header, rows) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _write_all(files) -> None:
    """write_nifti over (path, data, affine) triples on a thread pool (gzip
    releases the interpreter lock)."""
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for fut in [pool.submit(write_nifti, *f) for f in files]:
            fut.result()


def write_lidc(root, n: int, seed: int = 0, shape_xyz=(256, 256, 32),
               splits=("train", "val", "test"), raters: int = 2):
    """n LIDC nodules under `root`, labels alternating 0 / 1; -> root."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    x, y, z = shape_xyz
    gx, gy, gz = np.meshgrid(np.arange(x), np.arange(y), np.arange(z),
                             indexing="ij")
    rows, files = [], []
    for i, split in enumerate(_splits(n, splits)):
        pid, study, series = f"LIDC-IDRI-{i:04d}", f"1.3.6.{i}", f"1.3.6.{i}.1"
        d = root / "preprocessed_crop" / "data" / pid / study / series
        hu = rng.normal(-600, 300, (x, y, z))
        c = [int(rng.integers(s // 4, 3 * s // 4)) for s in (x, y, z)]
        r2 = (gx - c[0]) ** 2 + (gy - c[1]) ** 2 + 4 * (gz - c[2]) ** 2
        ball = r2 <= int(rng.integers(16, 64))
        hu[ball] += 700
        affine = np.diag([0.7, 0.7, 1.25, 1.0])
        files.append((d / "img_0.nii.gz",
                      np.clip(hu, -1024, 3000).astype(np.int16), affine))
        files.append((d / "seg_0.nii.gz", ball.astype(np.uint8), affine))
        files += [(d / f"seg_0_{r}.nii.gz",
                   (ball & (r2 <= 64 - 8 * r)).astype(np.uint8), affine)
                  for r in range(raters)]
        rows.append([pid, study, series, 0, raters, i % 2, 0, split])
    _write_all(files)
    _write_csv(root / "preprocessed" / "splits" / "split.csv",
               ["patient_id", "study_instance_uid", "series_instance_uid",
                "nodule_idx", "annotation_num", "Malignant", "Fold", "Split"],
               rows)
    return root


def write_mrnet(root, n: int, seed: int = 0, hw=(256, 256),
                slices=(20, 44), splits=("train", "val", "test"),
                affine=None):
    """n MRNet sagittal stacks under `root` with S ~ U[slices] slices each,
    but fewer than 32 (the crop pads them) on the odd IDs when slices[0] <
    32; labels alternating 0 / 1, a second label column; `affine` (default
    the identity, as step1 writes) on every stack; -> (root, {ID: S})."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    rows, counts, files = [], {}, []
    for i, split in enumerate(_splits(n, splits)):
        s = int(rng.integers(slices[0], slices[1] + 1))
        if i % 2 and slices[0] < 32:
            s = slices[0] + (s - slices[0]) % (32 - slices[0])
        counts[i] = s
        stack = rng.normal(60, 25, (s, *hw)).clip(0, 255).astype(np.uint8)
        files.append((root / "preprocessed" / "data" / "train" / "sagittal"
                      / f"{i:04d}.nii.gz", stack, affine))
        rows.append([i, int(rng.integers(0, 2)), i % 2, 0, "train", split])
    _write_all(files)
    _write_csv(root / "preprocessed" / "splits" / "split.csv",
               ["ID", "abnormal", "meniscus", "Fold", "Folder", "Split"], rows)
    return root, counts


def duke_arrays(seed: int = DUKE_SEED, n: int = DUKE_CASES):
    """{'Breast_MRI_{i:03d}': (volume [C, W, H, D] float32, affine [4, 4]
    float64)} of the DUKE fixture: integral intensities, so that gzip over
    shuffled bytes keeps the file small."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1, n + 1):
        vol = rng.integers(0, 64, DUKE_SHAPE).astype(np.float32)
        sp = rng.uniform(0.6, 1.0, 2)
        out[f"Breast_MRI_{i:03d}"] = (
            vol, np.diag([sp[0], sp[1], rng.uniform(2.0, 3.0), 1.0]))
    return out


def duke_split_rows(n: int = DUKE_CASES) -> list:
    """The fixture's split.csv rows (UID, PatientID, Malignant, Fold,
    Split): a second row of patient 2 (which `drop_duplicates` takes out),
    two folds, and a train / val / test split of fold 0."""
    split = _splits(n, ("train", "val", "test"))
    rows = [[i + 1, i + 1, i % 2, 0, split[i]] for i in range(n)]
    rows.insert(3, [2, 2, 1, 0, split[1]])
    rows += [[i + 1, i + 1, i % 2, 1, "train"] for i in range(n)]
    return rows
