"""Checkpoints of a run directory: a flat flax npz per checkpoint, and the
`best_checkpoint.json` pointer.

Counterpart of `mst_tpu/utils/checkpoint.py` (`save_checkpoint`,
`save_best_checkpoint`, `resolve_best_checkpoint`) for the top-1 policy of
the trainer: `<run_dir>/<name>/params.npz` holds the parameters as the flat
`/`-keyed flax tree (`models.convert.flax_params_from_torch`), which
`python -m mst_tpu_torch.serve --params_npz` loads, beside
`<name>.hparams.json`. The full train state with `--resume` is ROADMAP
queue A #4's remainder.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mst_tpu_torch.models import convert

BEST_POINTER = "best_checkpoint.json"
PARAMS_FILE = "params.npz"


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
