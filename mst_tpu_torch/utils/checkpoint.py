"""Checkpoints of a run directory: a flat flax npz per checkpoint, and the
`best_checkpoint.json` pointer.

Counterpart of `mst_tpu/utils/checkpoint.py` (`save_checkpoint`,
`save_best_checkpoint`, `resolve_best_checkpoint`) for the top-1 policy of
the trainer: `<run_dir>/<name>/params.npz` holds the parameters as the flat
`/`-keyed flax tree (`models.convert.flax_params_from_torch`), which
`python -m mst_tpu_torch.serve --params_npz` loads, beside
`<name>.hparams.json`; a ResNet's BatchNorm statistics (JAX's
`batch_stats` collection, which JAX keeps in every checkpoint,
`mst_tpu/utils/checkpoint.py:127-128, 158-159, 198-199`) go beside it into
`<name>/batch_stats.npz` with the flax keys. `load_hparams`,
`load_best_params` and `load_best_batch_stats` read a run folder back
(`serve.load_run_model`).

`save_train_state` / `restore_train_state` keep the full train state of
`--resume` (the counterparts of `mst_tpu/utils/checkpoint.py:110, 137`):
`<run_dir>/<name>/params.npz` as above, `<name>/optimizer.npz` with the
optimizer's per-parameter state under the parameters' flax keys (AdamW's
`exp_avg/<key>`, `exp_avg_sq/<key>` and `step/<key>`; Adafactor's
`v_row/<key>` and `v_col/<key>` or `v/<key>`; a frozen encoder has none),
its update count `count` (the schedule's), with gradient accumulation the
running mean `acc_grads/<key>` and `mini_step`, and the train state's
micro-batch count `state_step`, `<name>.meta.json` (the fit loop's counters:
epoch, best, best_epoch, stale) and `<name>.hparams.json`. A
`<name>/batch_stats.npz` where the model has BatchNorm. A
`TrainStateWriter` copies the state to the host on the caller's thread,
then writes it on a background thread (the JAX `use_async=True` save).
Every file is written under a temporary name and renamed into place, the
directory first.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mst_tpu_torch.models import convert

BEST_POINTER = "best_checkpoint.json"
PARAMS_FILE = "params.npz"
OPTIMIZER_FILE = "optimizer.npz"
BATCH_STATS_FILE = "batch_stats.npz"
STATE_STEP = "state_step"
COUNT = "count"
ACC_GRADS = "acc_grads"
MINI_STEP = "mini_step"


def save_checkpoint(run_dir, name: str, model,
                    hparams: Optional[Dict] = None) -> Path:
    """Write `model`'s parameters to <run_dir>/<name>/params.npz (and a
    ResNet's BatchNorm statistics to batch_stats.npz)."""
    run_dir = Path(run_dir)
    path = run_dir / name
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / PARAMS_FILE, **convert.flax_params_from_torch(model))
    stats = convert.flax_batch_stats_from_torch(model)
    if stats:
        np.savez(path / BATCH_STATS_FILE, **stats)
    if hparams is not None:
        (run_dir / f"{name}.hparams.json").write_text(
            json.dumps(hparams, indent=2))
    return path


def save_best_checkpoint(run_dir, name: str) -> None:
    """Write the pointer file (reference `base_model.py:51-54`)."""
    (Path(run_dir) / BEST_POINTER).write_text(
        json.dumps({"best_model_path": name}, indent=2))


def resolve_best_checkpoint(run_dir) -> str:
    return json.loads((Path(run_dir) / BEST_POINTER).read_text())[
        "best_model_path"]


def best_params_path(run_dir) -> Path:
    """The npz of the run's best checkpoint."""
    return Path(run_dir) / resolve_best_checkpoint(run_dir) / PARAMS_FILE


def load_hparams(run_dir) -> Optional[Dict]:
    """The hparams written beside the best checkpoint; None when there are
    none."""
    p = Path(run_dir) / f"{resolve_best_checkpoint(run_dir)}.hparams.json"
    return json.loads(p.read_text()) if p.exists() else None


def _load_npz(path: Path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_best_params(run_dir) -> Dict[str, np.ndarray]:
    """The best checkpoint's flat `/`-keyed flax parameter dict."""
    return _load_npz(best_params_path(run_dir))


def load_best_batch_stats(run_dir) -> Optional[Dict[str, np.ndarray]]:
    """The best checkpoint's flat BatchNorm statistics, or None for a
    model without BatchNorm."""
    path = best_params_path(run_dir).with_name(BATCH_STATS_FILE)
    return _load_npz(path) if path.exists() else None


# -- the full train state (`last`, `--resume`) --------------------------------


def _atomic_json(path: Path, obj) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj, indent=2))
    os.replace(tmp, path)


def _optimizer_arrays(model, optimizer) -> Dict[str, np.ndarray]:
    """The optimizer's state on the host: each parameter's (`STATE`) keyed
    by the flax names, the update count, and `MultiSteps`' running mean and
    mini-step."""
    key_of = {id(p): name.replace(".", "/")
              for name, p in model.named_parameters()}
    out = {COUNT: np.asarray(optimizer.count, np.int64)}
    for p in optimizer.held():
        st = optimizer.state.get(p) or {}
        for m in optimizer.STATE:
            if m in st:
                out[f"{m}/{key_of[id(p)]}"] = st[m].detach().cpu().numpy()
    acc = getattr(optimizer, "acc", None)
    if acc is not None:
        out[MINI_STEP] = np.asarray(optimizer.mini_step, np.int64)
        for p, a in acc.items():
            out[f"{ACC_GRADS}/{key_of[id(p)]}"] = a.detach().cpu().numpy()
    return out


class TrainStateWriter:
    """Writes train states (`save`) on one background thread, one at a time:
    the device-to-host copy runs on the caller's thread, so the next step
    cannot change what is written, and the disk write overlaps it (the JAX
    `use_async=True` save). `wait` joins the write and raises its error.
    `records` holds one dict a save: the copy's and the write's seconds and
    the bytes written."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        self.records: List[Dict] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._errors:
            raise self._errors.pop()

    def save(self, run_dir, name: str, state, meta: Optional[Dict] = None,
             hparams: Optional[Dict] = None) -> Path:
        """Write `state` (a `train.trainer.TrainState`: model, AdamW,
        update count) to <run_dir>/<name>/ and `meta` / `hparams` beside
        it, in the background."""
        run_dir = Path(run_dir)
        self.wait()
        t0 = time.perf_counter()
        params = convert.flax_params_from_torch(state.model)
        stats = convert.flax_batch_stats_from_torch(state.model)
        opt = _optimizer_arrays(state.model, state.optimizer)
        opt[STATE_STEP] = np.asarray(state.step, np.int64)
        copy_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            final = run_dir / name
            tmp = run_dir / f".{name}.{os.getpid()}.tmp"
            old = run_dir / f".{name}.{os.getpid()}.old"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            np.savez(tmp / PARAMS_FILE, **params)
            np.savez(tmp / OPTIMIZER_FILE, **opt)
            if stats:
                np.savez(tmp / BATCH_STATS_FILE, **stats)
            if final.exists():
                os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
            if meta is not None:
                _atomic_json(run_dir / f"{name}.meta.json", meta)
            if hparams is not None:
                _atomic_json(run_dir / f"{name}.hparams.json", hparams)
            self.records.append({
                "name": name, "copy_s": copy_s,
                "write_s": time.perf_counter() - t1,
                "bytes": sum(f.stat().st_size for f in final.iterdir())})

        def run():
            try:
                write()
            except BaseException as e:  # raised by the next wait()
                self._errors.append(e)

        self._thread = threading.Thread(target=run,
                                        name="mst-train-state-writer")
        self._thread.start()
        return run_dir / name


def save_train_state(run_dir, name: str, state, meta: Optional[Dict] = None,
                     hparams: Optional[Dict] = None) -> Path:
    """`TrainStateWriter.save`, waited for."""
    writer = TrainStateWriter()
    path = writer.save(run_dir, name, state, meta, hparams)
    writer.wait()
    return path


def restore_train_state(run_dir, name: str, state):
    """Load <run_dir>/<name>/ (written by `save_train_state`) into `state`
    in place: parameters, the optimizer's per-parameter state, its update
    count (a file without one: the micro-batch count), the accumulator's
    mean and mini-step, the micro-batch count, a ResNet's BatchNorm
    statistics. Returns (state, meta)."""
    import torch

    path = Path(run_dir) / name
    stats = path / BATCH_STATS_FILE
    convert.params_from_flax(
        state.model, _load_npz(path / PARAMS_FILE),
        _load_npz(stats) if stats.exists() else None)
    opt = _load_npz(path / OPTIMIZER_FILE)
    optimizer = state.optimizer
    state.step = int(opt.pop(STATE_STEP))
    optimizer.count = int(opt.pop(COUNT, state.step))
    named = {name_.replace(".", "/"): p
             for name_, p in state.model.named_parameters()}
    held = optimizer.held()
    index = {id(p): i for i, p in enumerate(held)}
    acc = getattr(optimizer, "acc", None)
    if (acc is None) != (MINI_STEP not in opt):
        raise KeyError(f"restore_train_state: {path} was written "
                       f"{'without' if acc is not None else 'with'} "
                       f"gradient accumulation")
    if acc is not None:
        optimizer.mini_step = int(opt.pop(MINI_STEP))
    by_param: Dict[str, Dict] = {}
    for k, v in opt.items():
        kind, key = k.split("/", 1)
        if kind not in (*optimizer.STATE, ACC_GRADS):
            raise KeyError(f"restore_train_state: {k} is not state of "
                           f"{type(optimizer).__name__}")
        by_param.setdefault(key, {})[kind] = torch.from_numpy(v)
    unknown = sorted(k for k in by_param
                     if k not in named or id(named[k]) not in index)
    if unknown:
        raise KeyError(f"restore_train_state: optimizer state of parameters "
                       f"the optimizer does not hold: {unknown[:8]}")
    if acc is not None:
        for k, st in by_param.items():
            p = named[k]
            acc[p] = st.pop(ACC_GRADS).to(p.device, p.dtype)
    sd = optimizer.inner.state_dict() if acc is not None \
        else optimizer.state_dict()
    sd["state"] = {index[id(named[k])]: st for k, st in
                   sorted(by_param.items()) if st}
    (optimizer.inner if acc is not None else optimizer).load_state_dict(sd)
    meta_path = Path(run_dir) / f"{name}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta
