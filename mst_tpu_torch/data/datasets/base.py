"""Dataset base: the split.csv table, the sample dict contract and the
native batch decode.

Counterpart of `mst_tpu/data/datasets/base.py` without pandas. Every
dataset yields dicts with (a superset of): uid, source [C, D, H, W]
float32, target int, and optionally mask [1, D, H, W], rater_masks
[R, 1, D, H, W], affine [4, 4], spacing_dhw [3], path, needs_padding_mask
(derive src_key_padding_mask from `mask`).

`SplitTable` reads `split.csv` as `pd.read_csv` types it (a column of
integers is int64, of numbers float64, else str) and keeps pandas' index
labels, and `load_split` filters it as the reference classmethod does
(`dataset_3d_lidc.py:104-112`): Fold == fold, then Split == split, then
the seeded fractional subsample of `df.sample(frac, random_state=0)
.reset_index()`, row for row in pandas' order. `prefetch_decode` decodes a
chunk's files through the native thread pool into an in-memory cache that
`__getitem__` drains; the disk decode cache of the JAX package
(`decode_cache`) is not ported.
"""

from __future__ import annotations

import csv
import os
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mst_tpu_torch.data import native_io
from mst_tpu_torch.data.transforms import AugmentConfig

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|[+-]?(inf|nan)",
                    re.IGNORECASE)


def _column(values):
    """pandas' type of a csv column: int64 when every cell is an integer,
    float64 when every cell is a number or empty (NaN), else str."""
    if all(_INT.fullmatch(v) for v in values):
        return np.array([int(v) for v in values], np.int64)
    if all(v == "" or _FLOAT.fullmatch(v) for v in values):
        return np.array([float(v) if v else np.nan for v in values],
                        np.float64)
    return np.array(values, dtype=object)


class SplitTable:
    """The rows of a split.csv: columns as numpy arrays and pandas' index
    labels (the csv row number until a reset)."""

    def __init__(self, columns: Dict[str, np.ndarray], index: np.ndarray):
        self.columns = columns
        self.index = np.asarray(index, np.int64)
        self._pos = {int(label): i for i, label in enumerate(self.index)}

    @classmethod
    def read_csv(cls, path) -> "SplitTable":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], [r for r in rows[1:] if r]
        columns = {name: _column([r[i] for r in body])
                   for i, name in enumerate(header)}
        return cls(columns, np.arange(len(body)))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, name) -> np.ndarray:
        return self.columns[name]

    def take(self, positions) -> "SplitTable":
        positions = np.asarray(positions, np.int64)
        return SplitTable({k: v[positions] for k, v in self.columns.items()},
                          self.index[positions])

    def reset_index(self, drop: bool = False) -> "SplitTable":
        """pandas' `reset_index`: labels 0..n-1; without `drop` the old
        labels become the column "index"."""
        cols = dict(self.columns)
        if not drop:
            cols = {"index": self.index.copy(), **cols}
        return SplitTable(cols, np.arange(len(self)))

    def loc(self, label) -> dict:
        """The row of index label `label`."""
        pos = self._pos[int(label)]
        return {k: v[pos] for k, v in self.columns.items()}

    def sort_desc(self, name) -> "SplitTable":
        """`sort_values(name, ascending=False)` in pandas' order: its
        `nargsort` reverses, argsorts with the (unstable) quicksort, and
        reverses again, which fixes the order of ties."""
        items = self.columns[name]
        idx = np.arange(len(items))[::-1]
        order = idx[items[::-1].argsort(kind="quicksort")][::-1]
        return self.take(order)

    def drop_duplicates(self, name) -> "SplitTable":
        """`drop_duplicates(subset=[name], keep="first")`."""
        seen, keep = set(), []
        for i, v in enumerate(self.columns[name].tolist()):
            if v not in seen:
                seen.add(v)
                keep.append(i)
        return self.take(keep)


def load_volume_dhw(path, native: bool = True):
    """A NIfTI volume as ([D, H, W] float32, affine): the native reader,
    or with `native=False` the numpy reader (`utils.nifti`), in the
    torchio -> torch axis order of the reference
    (`augmentations_3d.py:19-21`)."""
    if native:
        return native_io.read_nifti(path)
    from mst_tpu_torch.utils.nifti import read_nifti

    data, affine = read_nifti(path)
    if data.ndim == 4:  # [X, Y, Z, 1] -> [X, Y, Z]
        data = data[..., 0]
    return np.ascontiguousarray(
        np.transpose(np.asarray(data, np.float32), (2, 1, 0))), affine


class Dataset3D:
    LABEL: str = "target"

    def __init__(self, path_root, split: Optional[str] = None):
        self.path_root = Path(path_root)
        self.split = split
        self._decode_cache = {}

    def __len__(self):
        return len(self.item_pointers)

    # -- native batch decode ---------------------------------------------

    def nifti_paths(self, index) -> list:
        """NIfTI files `__getitem__(index)` reads (none for HDF5 data)."""
        return []

    def h5_items(self, index) -> list:
        """(file, dataset) pairs `__getitem__(index)` reads from HDF5."""
        return []

    def prefetch_decode(self, indices,
                        num_threads: Optional[int] = None) -> None:
        """Decode the chunk's files through the native thread pool into the
        in-memory cache that `__getitem__` drains; the DataModule's
        producer calls this once per batch. A failed decode is left to the
        per-sample read, which raises with the file's name."""
        if num_threads is None:
            num_threads = max(1, min(8, (os.cpu_count() or 1) - 1))
        paths = [str(p) for i in indices for p in self.nifti_paths(i)]
        paths = [p for p in paths if p not in self._decode_cache]
        if paths:
            try:
                self._decode_cache.update(zip(paths, native_io.read_nifti_batch(
                    paths, num_threads=min(num_threads, len(paths)))))
            except IOError:
                pass
        items = [(str(p), str(d)) for i in indices for p, d in self.h5_items(i)]
        items = [it for it in items if "::".join(it) not in self._decode_cache]
        if items:
            try:
                results = native_io.h5_read_batch(
                    items, num_threads=min(num_threads, len(items)))
                self._decode_cache.update(
                    ("::".join(it), r) for it, r in zip(items, results))
            except IOError:
                pass

    def _read_volume(self, path):
        """(vol [D, H, W], affine) of a NIfTI file: the prefetched decode
        (taken out of the cache) or the native reader."""
        out = self._decode_cache.pop(str(path), None)
        return out if out is not None else load_volume_dhw(path)

    def _read_h5(self, path, name):
        out = self._decode_cache.pop(f"{path}::{name}", None)
        return out if out is not None else native_io.h5_read(path, name)

    # -- the split --------------------------------------------------------

    @classmethod
    def load_split(cls, path, fold: int = 0, split: Optional[str] = None,
                   fraction: Optional[float] = None) -> SplitTable:
        df = SplitTable.read_csv(path)
        df = df.take(np.flatnonzero(df["Fold"] == fold))
        if split is not None:
            df = df.take(np.flatnonzero(df["Split"] == split))
        if fraction is not None:
            # pandas: size round(frac * n), RandomState(0).choice without
            # replacement, then reset_index()
            rs = np.random.RandomState(0)
            pos = rs.choice(len(df), size=round(fraction * len(df)),
                            replace=False)
            df = df.take(pos).reset_index()
        return df

    def augment_config(self, train: bool) -> AugmentConfig:
        raise NotImplementedError

    def labels(self) -> np.ndarray:
        return self.df[self.LABEL].astype(int)

    def class_counts(self) -> np.ndarray:
        """Label counts, for the balanced sampler's weights (reference
        `main_train.py:62-68`)."""
        return np.bincount(self.labels(), minlength=2)
