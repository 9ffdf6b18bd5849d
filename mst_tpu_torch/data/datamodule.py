"""DataModule: seeded weighted sampling, a host producer thread, and the
augmentation on the device with one batch of prefetch.

Counterpart of `mst_tpu/data/datamodule.py` for one process: the train
loader draws `num_train_samples` indices per epoch from a numpy generator
seeded with (seed, epoch) (with replacement under class weights, else a
permutation) and drops the last partial batch; val / test iterate in
order with the last batch partial.

- A producer thread builds each chunk's samples, collates them
  and stages the volumes in pinned memory, in `wire_dtype` (float16) for
  value-range pipelines (LIDC's HU window is exact in f16; the z-normed
  DUKE and MRNet ship f32), while a second thread decodes the next
  chunk's files through the native thread pool (`Dataset3D.
  prefetch_decode`); a stop event and timed puts let it exit when the
  consumer abandons the loader.
- The consumer copies batch k + 1 to the card (`non_blocking`) and queues
  its augmentation (`transforms.augment_batch`, per-sample seeds from the
  same crc32 key as the JAX loader) before it yields batch k, so the copy
  and the augmentation overlap the step on batch k.
- A dataset that asks for it (`needs_padding_mask`, MRNet) gets
  `src_key_padding_mask` [B, D] bool on the card, True where a slice is
  padding: its mask rides through the device pipeline's geometry.

Per-host sharding is queue A #13.
"""

from __future__ import annotations

import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from mst_tpu_torch.data.transforms import augment_batch

PREFETCH = 2  # collated batches the producer may hold ahead of the consumer


def _collate(samples):
    batch = {
        "uid": [s["uid"] for s in samples],
        "source": np.stack([s["source"] for s in samples]),
        "target": np.asarray([s["target"] for s in samples], np.int32),
    }
    for key in ("mask", "affine", "spacing_dhw"):
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    for key in ("rater_masks", "path"):
        if key in samples[0]:
            batch[key] = [s.get(key) for s in samples]
    batch["needs_padding_mask"] = bool(
        samples[0].get("needs_padding_mask", False))
    return batch


class DataModule:
    def __init__(self, ds_train=None, ds_val=None, batch_size: int = 1,
                 weights: Optional[np.ndarray] = None,
                 num_train_samples: Optional[int] = None, seed: int = 0,
                 device="cpu", wire_dtype=torch.float16, ds_test=None):
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

    # -- host side (producer thread) ----------------------------------------

    def _host(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """`arr` as a host tensor of `dtype` (default its own), in pinned
        memory for a CUDA device: one pass that converts as it copies."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        dtype = dtype or t.dtype
        if self.device.type != "cuda":
            return t.to(dtype)
        return torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)

    def _stage(self, ds, batch, train: bool) -> dict:
        """The collated batch's volumes (and the mask the device pipeline
        moves) as host tensors, pinned for the card."""
        cfg = ds.augment_config(train)
        if batch["needs_padding_mask"] and not cfg.has_mask:
            raise ValueError(
                "dataset requests src_key_padding_mask derivation but its "
                "AugmentConfig sets has_mask=False: the mask must ride "
                "through the device pipeline to stay consistent")
        src = batch["source"]
        batch["source"] = self._host(
            src, None if cfg.znorm_percentiles else self.wire_dtype)
        if cfg.has_mask:
            mask = batch.get("mask")
            if mask is None:
                mask = np.zeros((src.shape[0], 1, *src.shape[2:]), np.uint8)
            batch["_mask_host"] = self._host(mask)
        return batch

    # -- device side (consumer) ---------------------------------------------

    def _augment(self, ds, batch, train: bool, offset: int) -> dict:
        cfg = ds.augment_config(train)
        seeds = [zlib.crc32(f"{self.seed}|{self._epoch}|{offset + i}|{u}"
                            .encode()) for i, u in enumerate(batch["uid"])]
        vol = batch["source"].to(self.device, non_blocking=True)
        mask = batch.pop("_mask_host", None)
        if mask is None:
            batch["source"] = augment_batch(cfg, train, vol, seeds)
            return batch
        vol, mask = augment_batch(cfg, train, vol, seeds, mask.to(
            self.device, non_blocking=True))
        batch["source"] = vol
        if "mask" in batch or batch["needs_padding_mask"]:
            batch["mask"] = mask
        if batch["needs_padding_mask"]:
            # [B, D], True = padding (reference `dataset_3d_mrnet.py:82-88`)
            batch["src_key_padding_mask"] = ~(mask[:, 0].sum((-1, -2)) > 0)
        return batch

    def _iter_batches(self, ds, indices, train: bool) -> Iterator[dict]:
        bs = self.batch_size
        n_batches = len(indices) // bs if train else -(-len(indices) // bs)
        work_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        # a consumer that stops early (limit_val_batches) sets `stop`: the
        # timed puts let the producer see it instead of blocking forever
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    work_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        chunks = [[int(i) for i in indices[bi * bs:(bi + 1) * bs]]
                  for bi in range(n_batches)]
        prefetch = getattr(ds, "prefetch_decode", None)

        def producer():
            try:
                # the native pool decodes chunk k + 1 while this thread
                # crops and collates chunk k
                with ThreadPoolExecutor(1) as decoder:
                    ahead = None
                    if prefetch is not None and chunks:
                        ahead = decoder.submit(prefetch, chunks[0])
                    for bi, chunk in enumerate(chunks):
                        if stop.is_set():
                            return
                        if ahead is not None:
                            ahead.result()
                            ahead = (decoder.submit(prefetch, chunks[bi + 1])
                                     if bi + 1 < len(chunks) else None)
                        batch = self._stage(
                            ds, _collate([ds[i] for i in chunk]), train)
                        if not put(batch):
                            return
                put(None)
            except Exception as e:  # surfaces in the consumer
                put(e)
            except BaseException as e:
                put(e)
                raise

        thread = threading.Thread(target=producer, daemon=True,
                                  name="mst-loader")
        thread.start()
        pending, consumed = None, 0
        try:
            while True:
                batch = work_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                current = self._augment(ds, batch, train, offset=consumed)
                consumed += len(batch["uid"])
                if pending is not None:
                    yield pending
                pending = current
            if pending is not None:
                yield pending
        finally:
            stop.set()

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
