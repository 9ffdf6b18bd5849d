"""Attention constants and device dispatch shared by the port's ops.

Counterpart of `mst_tpu/ops/attention.py` for what the serving slice uses:
the finite mask value and the question `_on_tpu()` answers there (run the
hand-written kernel or its plain version), which here is "does this tensor
live on a CUDA device". The flash-attention kernels of that module are not
ported yet (ROADMAP queue A #10).
"""

from __future__ import annotations

import torch

# Finite "minus infinity" for masked scores: a fully masked row stays free
# of NaN (mst_tpu/ops/attention.py NEG_INF).
NEG_INF = -1e30


def _on_cuda(x: torch.Tensor) -> bool:
    """True when `x` must go through a CUDA kernel, False when it takes the
    plain PyTorch version (CPU). Any other device raises: there is no third
    path."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"mst_tpu_torch kernels run on CUDA or CPU tensors, got {x.device}")
