"""Step timing for the train loop (`history.jsonl`'s `perf/*` keys).

Counterpart of `mst_tpu/utils/profiling.py` `StepTimer`: host wall-clock
time per step, the first `warmup` steps skipped. The train step does not
synchronise the card, so a step's time is the time to enqueue it: it reads
the device's pace only once the launch queue is full (as the JAX timer reads
its asynchronous dispatch).

`trace(log_dir)` is the counterpart of its `trace` (`--profile_dir` of the
train CLI): a `torch.profiler` session with CPU and, where a CUDA device
is present, CUDA activity, written into `log_dir` as a Chrome trace
(`trace_<pid>_<ns>.json`); nothing when `log_dir` is empty.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class StepTimer:
    warmup: int = 2
    _times: List[float] = field(default_factory=list)
    _skipped: int = 0
    _t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._skipped < self.warmup:
                self._skipped += 1
            else:
                self._times.append(time.perf_counter() - t0)

    def stats(self, items_per_step: int = 1) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        p50 = float(np.percentile(t, 50))
        return {
            "steps": len(t),
            "p50_ms": p50 * 1e3,
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "mean_ms": float(t.mean() * 1e3),
            "items_per_sec": float(items_per_step / p50),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace into `log_dir` when it is given; no-op
    otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
