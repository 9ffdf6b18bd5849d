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
`__getitem__` drains.

The decoded-volume disk cache (`decode_cache=DIR`, default
`$MST_DECODE_CACHE`, `False` off; `mst_tpu/data/datasets/base.py:59-330`):
the first decode of a file writes its array to DIR, and every later read
loads it back (`np.load(mmap_mode="r")`, read-only: every consumer copies
before it writes) instead of inflating and parsing the file again. An
entry is named by the sha1 of the source's resolved path, `st_mtime_ns`,
size and (HDF5) dataset name, so that an edited source is decoded again,
and is the JAX package's: one directory serves both. A NIfTI volume is a
`<key>.vol.npy` stored as uint8 or int16 where that is lossless, and its
affine `<key>.aff.npy` (written first); an HDF5 dataset is a `<key>.npy`.
Writes go through a temporary file and a rename, on a write-behind thread
with a queue of 8 where the host has a spare core
(`$MST_CACHE_WRITE_BEHIND=1/0` decides), and are best-effort: a failed
write leaves the entry out. A corrupt entry is unlinked and decoded again.
"""

from __future__ import annotations

import csv
import hashlib
import os
import queue
import re
import threading
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
    _cache_dir: Optional[Path] = None

    def __init__(self, path_root, split: Optional[str] = None,
                 decode_cache=None):
        self.path_root = Path(path_root)
        self.split = split
        self._decode_cache = {}
        # None: $MST_DECODE_CACHE; False: off; else the directory
        if decode_cache is None:
            decode_cache = os.environ.get("MST_DECODE_CACHE") or None
        self._cache_dir = None
        if decode_cache:
            self._cache_dir = Path(decode_cache)
            self._cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self):
        return len(self.item_pointers)

    # -- native batch decode ---------------------------------------------

    def nifti_paths(self, index) -> list:
        """NIfTI files `__getitem__(index)` reads (none for HDF5 data)."""
        return []

    def h5_items(self, index) -> list:
        """(file, dataset) pairs `__getitem__(index)` reads from HDF5."""
        return []

    def _cached(self, path, name: Optional[str] = None) -> bool:
        cf = self._cache_file(path, name)
        return cf is not None and cf.exists()

    def prefetch_decode(self, indices,
                        num_threads: Optional[int] = None) -> None:
        """Decode the chunk's files through the native thread pool into the
        in-memory cache that `__getitem__` drains (and into the disk cache);
        the DataModule's producer calls this once per batch. Files the disk
        cache holds are skipped. A failed decode is left to the per-sample
        read, which raises with the file's name."""
        if num_threads is None:
            num_threads = max(1, min(8, (os.cpu_count() or 1) - 1))
        paths = [str(p) for i in indices for p in self.nifti_paths(i)]
        paths = [p for p in paths
                 if p not in self._decode_cache and not self._cached(p)]
        if paths:
            try:
                results = native_io.read_nifti_batch(
                    paths, num_threads=min(num_threads, len(paths)))
            except IOError:
                results = None
            if results is not None:
                self._decode_cache.update(zip(paths, results))
                for p, (vol, aff) in zip(paths, results):
                    self._cache_put_volume(self._cache_file(p), vol, aff)
        items = [(str(p), str(d)) for i in indices for p, d in self.h5_items(i)]
        items = [it for it in items if "::".join(it) not in self._decode_cache
                 and not self._cached(*it)]
        if items:
            try:
                results = native_io.h5_read_batch(
                    items, num_threads=min(num_threads, len(items)))
            except IOError:
                results = None
            if results is not None:
                self._decode_cache.update(
                    ("::".join(it), r) for it, r in zip(items, results))
                for it, r in zip(items, results):
                    self._cache_put(self._cache_file(*it), r)

    # -- the decoded-volume disk cache --------------------------------------

    def _cache_file(self, path, name: Optional[str] = None) -> Optional[Path]:
        """The cache entry of a file (or an (HDF5 file, dataset) pair), None
        without a cache or a readable source."""
        if self._cache_dir is None:
            return None
        p = Path(path)
        try:
            st = p.stat()
        except OSError:
            return None
        h = hashlib.sha1(
            f"{p.resolve()}|{st.st_mtime_ns}|{st.st_size}|{name or ''}"
            .encode()).hexdigest()
        return self._cache_dir / (
            h + (".npy" if name is not None else ".vol.npy"))

    @staticmethod
    def _aff_file(cache_file: Path) -> Path:
        return cache_file.with_name(
            cache_file.name[:-len(".vol.npy")] + ".aff.npy")

    @staticmethod
    def _atomic_save(cache_file: Path, arr) -> bool:
        """.npy under a temporary name (process and thread in it: the
        producer's inline write may race the write-behind thread on one
        entry), then renamed; False where the write failed."""
        tmp = cache_file.with_name(
            f"{cache_file.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, cache_file)
            return True
        except OSError:
            tmp.unlink(missing_ok=True)
            return False

    # one write-behind thread and queue, shared by every dataset
    _write_queue = None
    _write_queue_lock = threading.Lock()

    @classmethod
    def _writer(cls) -> "queue.Queue":
        with Dataset3D._write_queue_lock:
            q = Dataset3D._write_queue
            if q is None:
                q = queue.Queue(maxsize=8)

                def drain():
                    while True:
                        fn = q.get()
                        try:
                            fn()
                        except Exception:
                            pass  # best-effort, like the inline write
                        finally:
                            q.task_done()

                threading.Thread(target=drain, daemon=True,
                                 name="mst-cache-writer").start()
                Dataset3D._write_queue = q
        return q

    @classmethod
    def flush_cache_writes(cls) -> None:
        """Block until every queued cache write is on disk."""
        with Dataset3D._write_queue_lock:
            q = Dataset3D._write_queue
        if q is not None:
            q.join()

    @classmethod
    def _submit_write(cls, write) -> None:
        env = os.environ.get("MST_CACHE_WRITE_BEHIND")
        threaded = (env == "1") if env in ("0", "1") else (
            (os.cpu_count() or 1) > 1)
        if not threaded:
            write()  # no spare core: a writer thread only adds switching
            return
        try:
            cls._writer().put_nowait(write)
        except queue.Full:
            write()  # backpressure: the producer writes this one

    @classmethod
    def _cache_put(cls, cache_file: Optional[Path], arr) -> None:
        if cache_file is None or cache_file.exists():
            return
        cls._submit_write(lambda: cls._atomic_save(cache_file, arr))

    @classmethod
    def _cache_put_volume(cls, cache_file: Optional[Path], vol,
                          affine) -> None:
        if cache_file is None or cache_file.exists():
            return

        def write():
            if cache_file.exists():  # queued twice
                return
            v = vol
            # integral f32 volumes (CT, segmentations) stored as uint8 or
            # int16 where the values come back exactly
            with np.errstate(invalid="ignore"):  # inf / NaN: not equal
                for dt in (np.uint8, np.int16):
                    small = v.astype(dt)
                    if np.array_equal(v, small):
                        v = small
                        break
            # the affine first: a volume file means a complete pair
            if cls._atomic_save(cls._aff_file(cache_file), np.asarray(affine)):
                cls._atomic_save(cache_file, v)

        cls._submit_write(write)

    def _cache_get_volume(self, path):
        """(vol, affine) from the disk cache, None on a miss. A corrupt or
        half-written entry is unlinked (the pair), so that the decode that
        follows writes it again."""
        cf = self._cache_file(path)
        if cf is None or not cf.exists():
            return None
        try:
            return np.load(cf, mmap_mode="r"), np.load(self._aff_file(cf))
        except Exception:
            cf.unlink(missing_ok=True)
            self._aff_file(cf).unlink(missing_ok=True)
            return None

    def _read_volume(self, path):
        """(vol [D, H, W], affine) of a NIfTI file: the prefetched decode
        (taken out of the in-memory cache), the disk cache, or the native
        reader, whose result is written through to the disk cache."""
        out = self._decode_cache.pop(str(path), None)
        if out is not None:
            return out
        out = self._cache_get_volume(path)
        if out is not None:
            return out
        out = load_volume_dhw(path)
        self._cache_put_volume(self._cache_file(path), *out)
        return out

    def _read_h5(self, path, name):
        """An HDF5 dataset: prefetched, from the disk cache, or read by the
        native reader and written through."""
        out = self._decode_cache.pop(f"{path}::{name}", None)
        if out is not None:
            return out
        cf = self._cache_file(path, name)
        if cf is not None and cf.exists():
            try:
                return np.load(cf, mmap_mode="r")
            except Exception:
                cf.unlink(missing_ok=True)
        out = native_io.h5_read(path, name)
        self._cache_put(cf, out)
        return out

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
