"""Checkpoints of a run directory: a flat flax npz per checkpoint, and the
`best_checkpoint.json` pointer.

Counterpart of `mst_tpu/utils/checkpoint.py` (`save_checkpoint`,
`save_best_checkpoint`, `resolve_best_checkpoint`) for the top-1 policy of
the trainer: `<run_dir>/<name>/params.npz` holds the parameters as the flat
`/`-keyed flax tree (`models.convert.flax_params_from_torch`), which
`python -m mst_tpu_torch.serve --params_npz` loads, beside
`<name>.hparams.json`; `load_hparams` and `load_best_params` read a run
folder back (`serve.load_run_model`).

`save_train_state` / `restore_train_state` keep the full train state of
`--resume` (the counterparts of `mst_tpu/utils/checkpoint.py:110, 137`):
`<run_dir>/<name>/params.npz` as above, `<name>/optimizer.npz` with
AdamW's `exp_avg/<key>`, `exp_avg_sq/<key>` and `step/<key>` under the
parameters' flax keys (a frozen encoder has none) and the train state's
update count `state_step`, `<name>.meta.json` (the fit loop's counters:
epoch, best, best_epoch, stale) and `<name>.hparams.json`. A
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
STATE_STEP = "state_step"
MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def save_checkpoint(run_dir, name: str, model,
                    hparams: Optional[Dict] = None) -> Path:
    """Write `model`'s parameters to <run_dir>/<name>/params.npz."""
    run_dir = Path(run_dir)
    path = run_dir / name
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / PARAMS_FILE, **convert.flax_params_from_torch(model))
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


def load_best_params(run_dir) -> Dict[str, np.ndarray]:
    """The best checkpoint's flat `/`-keyed flax parameter dict."""
    with np.load(best_params_path(run_dir), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# -- the full train state (`last`, `--resume`) --------------------------------


def _atomic_json(path: Path, obj) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj, indent=2))
    os.replace(tmp, path)


def _optimizer_arrays(model, optimizer) -> Dict[str, np.ndarray]:
    """AdamW's per-parameter state on the host, keyed by the flax names."""
    key_of = {id(p): name.replace(".", "/")
              for name, p in model.named_parameters()}
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if not st:
                continue
            for m in MOMENTS:
                out[f"{m}/{key_of[id(p)]}"] = st[m].detach().cpu().numpy()
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
    in place: parameters, AdamW's moments and steps, the update count.
    Returns (state, meta)."""
    import torch

    path = Path(run_dir) / name
    with np.load(path / PARAMS_FILE, allow_pickle=False) as z:
        convert.params_from_flax(state.model, {k: z[k] for k in z.files})
    with np.load(path / OPTIMIZER_FILE, allow_pickle=False) as z:
        opt = {k: z[k] for k in z.files}
    state.step = int(opt.pop(STATE_STEP))
    named = {name_.replace(".", "/"): p
             for name_, p in state.model.named_parameters()}
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(held)}
    keys = {k.split("/", 1)[1] for k in opt}
    unknown = sorted(k for k in keys
                     if k not in named or id(named[k]) not in index)
    if unknown:
        raise KeyError(f"restore_train_state: optimizer state of parameters "
                       f"the optimizer does not hold: {unknown[:8]}")
    sd = state.optimizer.state_dict()
    sd["state"] = {index[id(named[k])]: {
        m: torch.from_numpy(opt[f"{m}/{k}"]) for m in MOMENTS}
        for k in sorted(keys)}
    state.optimizer.load_state_dict(sd)
    meta_path = Path(run_dir) / f"{name}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta
