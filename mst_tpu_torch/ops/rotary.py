"""Rotary positional encodings: RoPE of the DINOv3 encoder and of the
slice fusion, and LiRE (the slice fusion's learned rotary).

Counterpart of `mst_tpu/ops/rotary.py` (the JAX module imports jax, so the
port keeps its own copy): 'lang'-style inverse frequencies, the
interleaved-pair layout (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...),
the 1D angles of the fusion sequence (theta 256) and the axial 2D angles
of a patch grid. Angles are computed in float64 numpy and cast to float32,
as the JAX functions do; the kernels and the plain versions read cos / sin
of that f32 tensor.

LiRE rotates each block of `block` head features by R[p] = exp(p * A_b),
A_b the skew-symmetric matrix of the learned generators of block b. JAX
takes the exponential with `jax.scipy.linalg.expm` (Pade 13 with scaling
and squaring); the port with `torch.linalg.matrix_exp`, which has autograd.
The two agree to a few f32 ulps of the rotation's entries
(`tests/test_torch_slice_fusion.py` measures and states the limit).
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(dim: int, theta: float = 256.0) -> np.ndarray:
    """Inverse frequencies for 'lang' RoPE: 1/theta^(2i/dim), i < dim/2."""
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def rope_angles(seq_len: int, dim: int, theta: float = 256.0) -> torch.Tensor:
    """Angles [seq_len, dim] f32, each frequency repeated for its (x, y)
    pair (the interleaved layout)."""
    freqs = rope_frequencies(dim, theta)
    t = np.arange(seq_len, dtype=np.float64)
    ang = np.repeat(np.einsum("s,d->sd", t, freqs), 2, axis=-1)
    return torch.from_numpy(ang.astype(np.float32))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """RoPE of x [..., L, D] by the [L, D] f32 tables cos / sin: the
    rotation f32(x) * cos + (x @ P) * sin in f32 (the pair swap P is
    exact), the result in x's dtype. This is where the attention kernels
    and `mst_tpu`'s `_mhsa` round the rotated q and k."""
    xf = x.float()
    return (xf * cos + _rotate_half_interleaved(xf) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """RoPE of x [..., L, D] by angles [L, D]."""
    return apply_rope_tables(x, torch.cos(angles), torch.sin(angles))


def num_skew_params(block: int) -> int:
    """Free parameters of a block x block skew-symmetric matrix."""
    return block * (block - 1) // 2


def flat_to_skew(params: torch.Tensor, block: int) -> torch.Tensor:
    """[..., block*(block-1)/2] -> skew-symmetric [..., block, block]: the
    parameters fill the upper triangle row by row (numpy's `triu_indices`
    order, the reference's packing), the lower one is its negative."""
    iu = torch.triu_indices(block, block, offset=1, device=params.device)
    upper = params.new_zeros(*params.shape[:-1], block, block)
    upper[..., iu[0], iu[1]] = params
    return upper - upper.transpose(-1, -2)


def liere_rotations(params: torch.Tensor, positions: torch.Tensor,
                    block: int) -> torch.Tensor:
    """R[p, b] = exp(p * A_b) for each position and block: params [n_blocks,
    block*(block-1)/2] (the learned generators), positions [L] -> [L,
    n_blocks, block, block] f32, differentiable in `params`."""
    skew = flat_to_skew(params.float(), block)  # [nb, b, b]
    pos = positions.to(skew.device, torch.float32)
    return torch.linalg.matrix_exp(pos[:, None, None, None] * skew[None])


def apply_liere(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """The block-diagonal rotations [L, n_blocks, b, b] (n_blocks * b = D)
    applied to x [..., L, D] in f32, the result in x's dtype."""
    nb, b = rotations.shape[1], rotations.shape[2]
    xb = x.float().reshape(*x.shape[:-1], nb, b)  # [..., L, nb, b]
    out = torch.einsum("lnij,...lnj->...lni", rotations, xb)
    return out.reshape(x.shape).to(x.dtype)


def rope_2d_angles(grid_hw, dim: int, num_prefix: int = 1,
                   theta: float = 100.0,
                   normalized: bool = False) -> torch.Tensor:
    """Axial 2D RoPE angles [num_prefix + gh*gw, dim] f32 for a patch grid:
    half of `dim` rotates with the row coordinate, half with the column;
    prefix tokens (CLS + registers) get angle 0 (the identity).
    `normalized=True` is HF `DINOv3ViTRopePositionEmbedding`: patch centres
    normalised to [-1, 1] and scaled by 2*pi; `normalized=False` raw patch
    indices."""
    gh, gw = grid_hw
    freqs = rope_frequencies(dim // 2, theta)
    rows = np.repeat(np.arange(gh, dtype=np.float64), gw)
    cols = np.tile(np.arange(gw, dtype=np.float64), gh)
    if normalized:
        rows = (2.0 * (rows + 0.5) / gh - 1.0) * (2.0 * np.pi)
        cols = (2.0 * (cols + 0.5) / gw - 1.0) * (2.0 * np.pi)
    ang_r = np.repeat(np.einsum("s,d->sd", rows, freqs), 2, axis=-1)
    ang_c = np.repeat(np.einsum("s,d->sd", cols, freqs), 2, axis=-1)
    ang = np.concatenate([np.zeros((num_prefix, dim)),
                          np.concatenate([ang_r, ang_c], axis=-1)], axis=0)
    return torch.from_numpy(ang.astype(np.float32))


def rope_tables(grid_hw, dim: int, num_prefix: int, theta: float,
                normalized: bool, device) -> tuple:
    """(cos, sin) [num_prefix + gh*gw, dim] f32 on `device`, contiguous: the
    tables every RoPE sub-layer and kernel reads."""
    ang = rope_2d_angles(grid_hw, dim, num_prefix, theta, normalized).to(
        device)
    return torch.cos(ang).contiguous(), torch.sin(ang).contiguous()
