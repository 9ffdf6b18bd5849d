"""DataModule: seeded weighted sampling, batching, augmentation on the device.

Counterpart of `mst_tpu/data/datamodule.py` for one process: the train
loader draws `num_train_samples` indices per epoch from a numpy generator
seeded with (seed, epoch) — with replacement under class weights, else a
permutation — and drops the last partial batch; val / test iterate in
order with the last batch partial. Batches are collated on the host,
shipped in `wire_dtype` (float16, as the JAX loader ships value-range
volumes) and augmented on `device` (`transforms.augment_batch`) with
per-sample seeds from the same crc32 key as the JAX loader; the test split
(the predict CLI's) iterates like val. The prefetch thread, segmentation
masks, per-host sharding and the reference datasets come with the host
data path and multi-GPU (ROADMAP queue A #5, #13).
"""

from __future__ import annotations

import zlib
from typing import Iterator, Optional

import numpy as np
import torch

from mst_tpu_torch.data.transforms import augment_batch


def _collate(samples):
    return {
        "uid": [s["uid"] for s in samples],
        "source": np.stack([s["source"] for s in samples]),
        "target": np.asarray([s["target"] for s in samples], np.int32),
    }


class DataModule:
    def __init__(self, ds_train=None, ds_val=None, batch_size: int = 1,
                 weights: Optional[np.ndarray] = None,
                 num_train_samples: Optional[int] = None, seed: int = 0,
                 device="cpu", wire_dtype=np.float16, ds_test=None):
        self.ds_train, self.ds_val, self.ds_test = ds_train, ds_val, ds_test
        self.batch_size = batch_size
        self.weights = None if weights is None else np.asarray(weights,
                                                               np.float64)
        self.num_train_samples = num_train_samples
        self.seed = seed
        self.device = torch.device(device)
        self.wire_dtype = wire_dtype
        self._epoch = 0

    def _train_indices(self) -> np.ndarray:
        n = len(self.ds_train)
        num = self.num_train_samples or n
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.weights is None:
            return rng.permutation(n)[:min(num, n)]
        return rng.choice(n, size=num, replace=True,
                          p=self.weights / self.weights.sum())

    def _augment(self, ds, batch, train: bool, offset: int):
        cfg = ds.augment_config(train)
        seeds = [zlib.crc32(f"{self.seed}|{self._epoch}|{offset + i}|{u}"
                            .encode()) for i, u in enumerate(batch["uid"])]
        src = batch["source"]
        if self.wire_dtype is not None and cfg.znorm_percentiles is None:
            src = src.astype(self.wire_dtype)
        batch["source"] = augment_batch(
            cfg, train, torch.from_numpy(src).to(self.device), seeds)
        return batch

    def _iter_batches(self, ds, indices, train: bool) -> Iterator[dict]:
        bs = self.batch_size
        n_batches = len(indices) // bs if train else -(-len(indices) // bs)
        for bi in range(n_batches):
            chunk = indices[bi * bs:(bi + 1) * bs]
            yield self._augment(ds, _collate([ds[int(i)] for i in chunk]),
                                train, offset=bi * bs)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def train_dataloader(self) -> Iterator[dict]:
        idx = self._train_indices()
        self._epoch += 1
        return self._iter_batches(self.ds_train, idx, train=True)

    def eval_valid_mask(self, n: int) -> np.ndarray:
        """True for every real sample of the eval stream (one process pads
        nothing; the multi-host wrap padding is queue A #13)."""
        return np.ones(n, bool)

    def val_dataloader(self) -> Iterator[dict]:
        return self._iter_batches(self.ds_val, np.arange(len(self.ds_val)),
                                  train=False)

    def test_dataloader(self) -> Iterator[dict]:
        return self._iter_batches(self.ds_test,
                                  np.arange(len(self.ds_test)), train=False)


def balanced_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample weights 0.5 / class_count (reference `main_train.py:62-68`)."""
    labels = np.asarray(labels).astype(int)
    counts = np.bincount(labels)
    w = 0.5 / np.maximum(counts, 1)
    return w[labels]
