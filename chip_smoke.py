#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (it never
runs on the CPU: without a card it exits non-zero before printing any
result). Phases, each printing lines tagged with the card's name and power
limit:

1. device: the card, `nvidia-smi` name and power limit, TF32 off;
2. build: `nvcc` builds `mst_tpu_torch/csrc/*.cu` (timed);
3. kernels: each hand-written kernel and each fused sub-layer against its
   plain PyTorch version at the ViT-S path shapes ([256, 257, 384] bf16,
   6 heads, O(1) LayerScale, tanh and erf GELU);
4. forward: MST-DINOv2 ViT-S/14 on [8, 1, 32, 224, 224], built as
   `python -m mst_tpu_torch.serve --params_npz` builds it from seeded
   random weights (`build_model`): kernel path vs plain path (with and
   without a key-padding mask), launch counts per forward;
5. server: `build_server` (`BatchingPredictor` + `serve_http` on
   127.0.0.1) answers concurrent POSTs (a padded tail batch included) and
   `/healthz`; the kernel launch counts are read around this run;
6. times: kernels vs plain versions (CUDA events, median), end-to-end
   vol/s at B=8, peak device memory;
7. train kernels: each kernel of the train step (the residual-saving modes
   of `ln_gemm` and `mhsa`, `gemm_dls`, `gemm_wgrad`, `gemm_dgrad`,
   `mhsa_bwd`) and each train sub-layer's forward residuals and backward
   outputs against their plain versions at the path shapes;
8. train step: ViT-S/14 at B=8 built by `python -m mst_tpu_torch.train`'s
   own builders from seeded weights with O(1) LayerScale; loss and every
   parameter's grad on the kernels vs the same step on the plain train
   sub-layers, launch counts per step, then K AdamW steps on one batch on
   both paths (the loss must fall, and the paths must agree);
9. trainer: `Trainer.fit` for 2 epochs on LIDC-shaped Synthetic data; the
   run folder's files; the best checkpoint served by
   `python -m mst_tpu_torch.serve`'s `build_model` gives the eval step's
   probs;
10. train times: the train kernels vs their plain versions, the train
   step on the kernels and on the plain sub-layers (ms, vol/s), its peak
   memory, and a `torch.profiler` breakdown of one step;
11. saliency kernels: the CLS-row, rollout-carry (two chained blocks, so
   that a carry that is not one-hot is fed back) and Abnar-factor outputs
   of `mhsa`, and their sub-layers, against their plain versions at the
   path shapes, each run twice for the same bits;
12. saliency forward: `fused_mst_saliency` at B=8 in the plane modes
   `last`, `rollout` and `rollout_abnar`, with and without a key-padding
   mask, against the plain path and an f32 plain forward, launch counts
   per forward, and the `MST_NO_CHEAP_LAST` row against the cheap one;
13. predict CLI: `python -m mst_tpu_torch.predict`'s `main` with
   `--use_tta --use_rollout --save_saliency` on phase 9's run folder and
   LIDC-shaped Synthetic test volumes; `results.csv` and the NIfTI volumes
   against the predictor;
14. saliency times: the saliency kernels and sub-layers vs their plain
   versions, vol/s per plane mode at B=8 against the forward without
   saliency, the per-volume latency of batch-1 TTA with saliency, peak
   memory, and a `torch.profiler` breakdown of each mode's forward.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises (exit code != 0).
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gzip
import io
import json
import math
import shutil
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_SLICES, S, E, HEADS = 256, 257, 384, 6  # B=8 x D=32 slices, ViT-S/14
BATCH, DEPTH_SLICES, PX = 8, 32, 224
SEED = 0
# Limits on probabilities, each a few times the largest difference measured
# on an H100 with these seeded inputs (the readings are in PERF.md). Each
# phase also checks that the volumes' own probs lie further apart than its
# limit, so a row served from the wrong volume or slot cannot pass.
PROB_TOL = 0.01  # kernel path vs plain path, both bf16 (phase 4)
F32_TOL = 0.015  # bf16 kernel path vs f32 plain path (phase 4)
SERVE_TOL = 1e-3  # server rows vs one direct batch (phase 5)
# Train phases (7-10). Limits are a few times the largest reading on an
# H100 with these seeded inputs (the readings are in PERF.md). bf16
# outputs use the 2-ulp limit of phase 3; f32 grads a limit relative to
# the grad's largest magnitude, because their sums run in another order.
KERNEL_GRAD_REL = 2e-5  # one kernel's f32 outputs vs its plain version
SUBLAYER_GRAD_REL = 3e-3  # a sub-layer's f32 grads, kernel vs plain chain
# Phase 8: the B=8 step of a random-weight ViT-S with O(1) LayerScale in
# bf16 moves its grads by a few percent under any change of rounding, so
# both bf16 paths are also held against the same step in f32 (plain
# sub-layers): the kernel path must be as close to it as the plain path.
STEP_LOSS_TOL = 2e-3  # |loss kernel path - loss plain path|
STEP_GRAD_REL = 0.5  # a grad, kernel vs plain path, / its |plain|max
STEP_F32_RATIO = 1.5  # kernel path's error vs f32 / the plain path's
FIT_STEPS, FIT_LR = 8, 1e-4  # AdamW steps on one batch
FIT_DROP = 10.0  # the loss must fall by this factor over those steps
FIT_TRACK_TOL = 0.15  # |loss kernel - loss plain| at every one of them
# Saliency phases (11-14). A saliency map is compared relative to its
# largest value; the limits are a few times the largest reading on an H100
# with these seeded inputs (the readings are in PERF.md).
SAL_REL = 0.05  # saliency, kernel path vs plain path, both bf16
SAL_F32_REL = 0.05  # saliency, bf16 kernel path vs f32 plain path
SAL_CHEAP_REL = 0.01  # saliency, MST_NO_CHEAP_LAST row vs the cheap row
PLANE_MODES = ("last", "rollout", "rollout_abnar")
N_CASES = 8  # Synthetic test volumes the predict CLI scores


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def ulp_bf16(x: float) -> float:
    """bf16 spacing at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def row_gaps(probs) -> np.ndarray:
    """[n, n] max-abs distances between the rows of [n, classes] probs."""
    p = np.asarray(probs, np.float64)
    return np.abs(p[:, None] - p[None]).max(-1)


def min_row_gap(probs) -> float:
    """Smallest distance between two rows of [n, classes] probs."""
    g = row_gaps(probs)
    return float(g[np.triu_indices(len(g), 1)].min())


def spread_volumes(rng, predict, n: int, pool: int = 48) -> np.ndarray:
    """n seeded [1, D, H, W] volumes whose probs lie far apart.

    A random-weight model gives noise volumes nearly equal probs, and then
    a limit on |probs - reference| cannot tell a row of the wrong volume or
    slot. So `pool` candidates are drawn (noise of its own scale, offset
    and 56-pixel block pattern each) and n are kept greedily, each the one
    furthest from those already kept, on the probs of the kernel path."""
    f32, one = np.float32, (pool, 1, 1, 1, 1)
    cand = rng.standard_normal((pool, 1, DEPTH_SLICES, PX, PX), dtype=f32)
    cand *= rng.uniform(0.25, 2.0, one).astype(f32)
    cand += rng.uniform(-1.5, 1.5, one).astype(f32)
    blocks = rng.standard_normal((pool, 1, DEPTH_SLICES, 4, 4), dtype=f32)
    blocks *= rng.uniform(0.0, 2.0, one).astype(f32)
    cand += np.repeat(np.repeat(blocks, PX // 4, axis=3), PX // 4, axis=4)
    probs = np.concatenate([predict(cand[i:i + BATCH], None)[0].cpu().numpy()
                            for i in range(0, pool, BATCH)])
    gaps = row_gaps(probs)
    keep = [int(np.argmin(probs[:, 0]))]
    while len(keep) < n:
        nearest = gaps[:, keep].min(axis=1)
        nearest[keep] = -1.0
        keep.append(int(np.argmax(nearest)))
    return cand[keep]


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_outputs(tag, name, kern, plain, rel) -> float:
    """Hold a tuple of outputs against its plain version: bf16 ones within
    2 bf16 ulps at the plain output's largest magnitude, f32 ones within
    `rel` times it. Prints each reading beside its limit; returns the
    largest absolute error."""
    kern = kern if isinstance(kern, (tuple, list)) else (kern,)
    plain = plain if isinstance(plain, (tuple, list)) else (plain,)
    check(len(kern) == len(plain), f"{name}: {len(kern)} != {len(plain)}")
    worst = 0.0
    for i, (k, pl) in enumerate(zip(kern, plain)):
        label = f"{name}[{i}]"
        if pl is None:
            check(k is None, f"{label}: unexpected output")
            continue
        check(tuple(k.shape) == tuple(pl.shape) and k.dtype == pl.dtype,
              f"{label}: {tuple(k.shape)} {k.dtype} != {tuple(pl.shape)} "
              f"{pl.dtype}")
        check(bool(torch.isfinite(k.float()).all()), f"{label}: non-finite")
        scale = pl.float().abs().max().item()
        err = (k.float() - pl.float()).abs().max().item()
        lim = 2 * ulp_bf16(scale) if k.dtype == torch.bfloat16 else rel * scale
        print(f"{tag} {label}: {list(k.shape)} {str(k.dtype)[6:]} "
              f"max_abs_err={err:.6g} limit={lim:.6g} (|plain|max={scale:.6g})")
        check(err <= lim, f"{label}: max_abs_err {err} > {lim}")
        worst = max(worst, err)
    return worst


def read_nifti_f32(path) -> np.ndarray:
    """The data of a float32 NIfTI-1 file that `utils.nifti.write_nifti`
    wrote (352-byte header and extension flag, then Fortran order)."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    ndim = struct.unpack_from("<h", raw, 40)[0]
    dims = struct.unpack_from(f"<{ndim}h", raw, 42)
    check(struct.unpack_from("<h", raw, 70)[0] == 16, f"{path}: not float32")
    return np.frombuffer(raw[352:], np.float32).reshape(dims, order="F")


def profile_device(tag, label, fn, top: int) -> None:
    """Print the device's busy and idle share over one call of `fn` and its
    `top` kernels by device time (`torch.profiler`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    # kernels only: a CPU-side entry also carries its kernels' device time,
    # and a GPU user annotation (the optimizer step's) spans its kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3  # ms
    print(f"{tag} profile of {label}: wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f}%")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x  {e.key[:110]}")


def host_seconds(fn, n: int = 5) -> float:
    """Median host time of `fn()` ending in a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t1)
    return statistics.median(ts)


def train_sublayer_outputs(fb, kind, ops, x, args, g):
    """(y, residuals, dx, every argument's grad) of one train sub-layer on
    `ops` (fb.KERNELS or fb.PLAIN), `args` after x with f32 matrices."""
    fn, fwd = ((fb.fused_attention_sublayer_train, fb._attn_train_fwd)
               if kind == "attn" else
               (fb.fused_mlp_sublayer_train, fb._mlp_train_fwd))
    xx = x.clone().requires_grad_(True)
    aa = [a.clone().requires_grad_(True) if torch.is_tensor(a) else a
          for a in args]
    fn(xx, *aa, ops=ops).backward(g)
    cast = [a.to(x.dtype) if torch.is_tensor(a) and a.dim() == 2 else a
            for a in args]
    y, res = fwd(ops, x, *cast)
    return (y, *res, xx.grad, *[a.grad for a in aa if torch.is_tensor(a)])


def main() -> int:
    if not (ROOT / "mst_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (mst_tpu_torch/csrc not found)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))

    from mst_tpu_torch import predict as predict_cli
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
    from mst_tpu_torch.models.vit_fast import fused_mst_logits, fused_mst_saliency
    from mst_tpu_torch.ops import _build
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import MODEL, build_model, build_server, parse_args
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.predictor import make_predict_fn
    from mst_tpu_torch.train.trainer import (
        TrainState,
        cross_entropy_loss,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from mst_tpu_torch.utils.checkpoint import best_params_path
    from mst_tpu_torch.utils.nifti import write_nifti

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    tag = f"[{smi}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"{tag} device: {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"{tag} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)  # -Xptxas -v: registers, spills
    _build.lib()
    print(f"{tag} build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib_path.relative_to(ROOT)}")

    # -- 3. kernels vs plain at the path's shapes --------------------------
    rng = np.random.default_rng(SEED)

    def t(arr, dtype=torch.float32):
        return torch.from_numpy(np.asarray(arr, np.float32)).to(dev, dtype)

    def rand(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return t(off + scale * rng.standard_normal(shape), dtype)

    bf = torch.bfloat16
    M = N_SLICES * S
    x = rand(N_SLICES, S, E, dtype=bf)
    x2 = x.reshape(M, E)
    ln_s, ln_b = rand(E, scale=0.1, off=1.0), rand(E, scale=0.1)
    wqkv, bqkv = rand(E, 3 * E, scale=E ** -0.5, dtype=bf), rand(3 * E, scale=0.1)
    wproj, bproj = rand(E, E, scale=E ** -0.5, dtype=bf), rand(E, scale=0.1)
    w1, b1 = rand(E, 4 * E, scale=E ** -0.5, dtype=bf), rand(4 * E, scale=0.1)
    w2, b2 = rand(4 * E, E, scale=(4 * E) ** -0.5, dtype=bf), rand(E, scale=0.1)
    # O(1) LayerScale (the init value 1e-5 would hide the branch entirely)
    ls = rand(E, scale=0.1, off=1.0)
    qkv_in = fb._ln_gemm_ref(x2, ln_s, ln_b, wqkv, bqkv, fb.ACT_NONE, 1e-6)
    o_in = fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS)
    h_in = fb._ln_gemm_ref(x2, ln_s, ln_b, w1, b1, fb.ACT_GELU_TANH, 1e-6)

    print(f"{tag} kernel tolerance: max|kernel - plain| <= 2 bf16 ulps at "
          f"the output's largest magnitude (both sides round at the same "
          f"points; only the f32 summation order differs, which can flip "
          f"one bf16 rounding of an intermediate)")
    def pair(kernel_fn, plain_fn, *args):
        """A kernel wrapper and its plain version on the same arguments."""
        return (lambda: kernel_fn(*args)), (lambda: plain_fn(*args))

    eps = 1e-6
    cases = {
        "ln_gemm[qkv]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s, ln_b,
                             wqkv, bqkv, fb.ACT_NONE, eps),
        "ln_gemm[fc1,gelu_tanh]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s,
                                       ln_b, w1, b1, fb.ACT_GELU_TANH, eps),
        "ln_gemm[fc1,gelu_erf]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s,
                                      ln_b, w1, b1, fb.ACT_GELU_ERF, eps),
        "mhsa": pair(fb.mhsa, fb._mhsa_ref, qkv_in, N_SLICES, S, HEADS),
        "gemm_residual[proj,ls]": pair(fb.gemm_residual, fb._gemm_residual_ref,
                                       o_in, wproj, bproj, ls, x2),
        "gemm_residual[proj,no_ls]": pair(fb.gemm_residual,
                                          fb._gemm_residual_ref, o_in, wproj,
                                          bproj, None, x2),
        "gemm_residual[fc2,ls]": pair(fb.gemm_residual, fb._gemm_residual_ref,
                                      h_in, w2, b2, ls, x2),
    }
    attn_args = (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
    mlp_args = (x, ln_s, ln_b, w1, b1, w2, b2)
    for label, lsv in (("ls", ls), ("no_ls", None)):
        cases[f"attention_sublayer[{label}]"] = pair(
            fb.fused_attention_sublayer, fb._attn_ref, *attn_args, lsv, HEADS)
    for label, lsv, approx in (("tanh,ls", ls, True), ("erf,ls", ls, False),
                               ("tanh,no_ls", None, True)):
        cases[f"mlp_sublayer[{label}]"] = pair(
            fb.fused_mlp_sublayer, fb._mlp_ref, *mlp_args, lsv, approx)
    errs = {}
    for name, (kern, plain) in cases.items():
        k, p = kern(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k.float()).all()), f"{name}: non-finite")
        d = (k.float() - p.float()).abs()
        scale = p.float().abs().max().item()
        tol = 2 * ulp_bf16(scale)
        err = d.max().item()
        rel = err / scale
        errs[name] = err
        print(f"{tag} kernel {name}: shape={list(k.shape)} max_abs_err={err:.6g}"
              f" max_rel_err={rel:.6g} tol={tol:.6g} (|plain|max={scale:.6g})")
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")

    # -- 4. full forward ---------------------------------------------------
    # The model is built as `python -m mst_tpu_torch.serve --params_npz`
    # builds it, from seeded random weights with O(1) LayerScale so that
    # every block counts.
    flat = random_flax_params(get_model(MODEL), SEED)
    for key in flat:
        if key.endswith("/gamma"):
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    npz = ROOT / "build" / "chip_smoke_params.npz"  # gitignored
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, **flat)
    args = parse_args(["--params_npz", str(npz), "--port", "0",
                       "--batch_size", "4", "--max_wait_ms", "1000"])
    model = build_model(args)
    check(model.dtype == torch.bfloat16, f"serving dtype {model.dtype}")
    predict = make_predict_fn(model, with_saliency=False)
    vol = spread_volumes(rng, predict, BATCH)
    mask = np.zeros((BATCH, DEPTH_SLICES), bool)
    mask[1, 24:] = True  # volume 1: its last 8 slices are padding
    mask[5, 30:] = True

    @contextlib.contextmanager
    def plain_sublayers():
        """Route the blocks' serving sub-layers (the saliency ones too)
        through the plain versions on the card."""
        plain = {"fused_attention_sublayer": fb._attn_ref,
                 "fused_mlp_sublayer": fb._mlp_ref,
                 "fused_attention_sublayer_with_row": fb._attn_with_row_ref,
                 "fused_attention_sublayer_rollout": fb._attn_rollout_ref,
                 "fused_attention_sublayer_abnar": fb._attn_abnar_ref}
        saved = {k: getattr(layers, k) for k in plain}
        for k, fn in plain.items():
            setattr(layers, k, fn)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(layers, k, fn)

    print(f"{tag} forward tolerance: |probs kernel - probs plain| <= "
          f"{PROB_TOL} (bf16 roundings flipped by the summation order "
          f"compound over 11 blocks of a random-weight ViT-S)")
    n_blocks = 11  # block 11 is the CLS-only plain block
    per_fwd = {**{k: 0 for k in fb.launch_counts()}, "ln_gemm": 2 * n_blocks,
               "mhsa": n_blocks, "gemm_residual": 2 * n_blocks}
    calls_per_fwd = {**{k: 0 for k in fb.sublayer_calls()},
                     "fused_attention_sublayer": n_blocks,
                     "fused_mlp_sublayer": n_blocks}
    for label, m in (("no mask", None), ("key-padding mask", mask)):
        fb.reset_launch_counts()
        pk, _ = predict(vol, m)
        torch.cuda.synchronize()
        counts, calls = fb.launch_counts(), fb.sublayer_calls()
        with plain_sublayers():
            pp, _ = predict(vol, m)
        torch.cuda.synchronize()
        check(tuple(pk.shape) == (BATCH, 2), f"probs shape {tuple(pk.shape)}")
        check(bool(torch.isfinite(pk).all()), "non-finite probs")
        check(bool(torch.allclose(pk.sum(-1), torch.ones(BATCH, device=dev),
                                  atol=1e-5)), "probs do not sum to 1")
        err = (pk - pp).abs().max().item()
        gap = min_row_gap(pp.cpu())
        print(f"{tag} forward [{label}] {list(vol.shape)}: probs[0]="
              f"{pk[0].tolist()} max|kernel-plain|={err:.6g} "
              f"min gap between volumes={gap:.6g} launches={counts} "
              f"sublayer calls={calls}")
        check(err <= PROB_TOL, f"forward [{label}]: {err} > {PROB_TOL}")
        check(gap > PROB_TOL, f"forward [{label}]: volumes {gap} apart, "
              f"within the tolerance {PROB_TOL}")
        check(counts == per_fwd, f"launch counts {counts} != {per_fwd}")
        check(calls == calls_per_fwd,
              f"sub-layer calls {calls} != {calls_per_fwd}")
    # padded slices must not move the masked volume's probs
    vol2 = vol.copy()
    vol2[1, :, 24:] = 100.0 * rng.standard_normal(vol2[1, :, 24:].shape)
    pm, _ = predict(vol, mask)
    pm2, _ = predict(vol2, mask)
    d_pad = (pm[1] - pm2[1]).abs().max().item()
    print(f"{tag} forward: perturbing padded slices moves probs by {d_pad:.6g}")
    check(d_pad <= 1e-6, f"padded slices leak into the result ({d_pad})")
    # the bf16 kernel path against the plain path in f32 on the card
    with plain_sublayers(), torch.inference_mode():
        p32 = torch.softmax(fused_mst_logits(
            model, torch.from_numpy(vol).to(dev), dtype=torch.float32), -1)
    pk, _ = predict(vol, None)
    d32 = (pk - p32).abs().max().item()
    gap32 = min_row_gap(p32.cpu())
    print(f"{tag} forward: max|probs bf16 kernel path - probs f32 plain "
          f"path|={d32:.6g} (tol {F32_TOL}: bf16 end-to-end error of a "
          f"12-block ViT with O(1) LayerScale); min gap between volumes "
          f"(f32)={gap32:.6g}")
    check(d32 <= F32_TOL, f"bf16 kernel path vs f32: {d32} > {F32_TOL}")
    check(gap32 > F32_TOL, f"f32 volumes {gap32} apart, within {F32_TOL}")

    # -- 5. server (the main path; launch counts read around it) ----------
    n_req, bs = 6, args.batch_size
    vols = spread_volumes(rng, predict, n_req)
    direct, _ = predict(vols, None)
    direct = direct.cpu().numpy()
    gap = min_row_gap(direct)
    print(f"{tag} server: min gap between the {n_req} volumes' direct probs "
          f"{gap:.6g} (must exceed the tolerance {SERVE_TOL})")
    check(gap > SERVE_TOL, f"direct probs {gap} apart, within {SERVE_TOL}")
    fb.reset_launch_counts()
    server, bp = build_server(args, model)
    port = server.server_address[1]
    results, errors = [None] * n_req, []

    def post(i):
        try:
            buf = io.BytesIO()
            np.save(buf, vols[i])
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())
        except Exception as e:  # reported below; the phase then fails
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        bp.close()
    torch.cuda.synchronize()
    served_counts, served_calls = fb.launch_counts(), fb.sublayer_calls()
    check(not errors and all(not th.is_alive() for th in threads),
          f"requests failed: {errors}")
    worst = max(float(np.abs(np.asarray(results[i]["probs"]) - direct[i]).max())
                for i in range(n_req))
    print(f"{tag} server: {n_req} concurrent POSTs, batch {bs}: "
          f"batches_run={bp.batches_run} healthz={health} "
          f"max|served-direct|={worst:.6g} (tol {SERVE_TOL}: the kernels "
          f"work row by row, but cuBLAS may pick another algorithm for "
          f"another batch size in the plain parts)")
    check(health["ok"] and health["volumes_served"] == n_req
          and health["model"] == MODEL, f"healthz {health}")
    check(bp.batches_run >= 2, "a batch of 4 cannot hold 6 volumes")
    check(worst <= SERVE_TOL, f"served probs differ from direct: {worst}")
    check(all(results[i]["pred"] == int(np.argmax(results[i]["probs"]))
              for i in range(n_req)), "pred is not argmax(probs)")
    want = {k: v * bp.batches_run for k, v in per_fwd.items()}
    want_calls = {k: v * bp.batches_run for k, v in calls_per_fwd.items()}
    print(f"{tag} server launches: {served_counts} sublayer calls: "
          f"{served_calls}")
    check(served_counts == want, f"server launch counts {served_counts} != {want}")
    check(served_calls == want_calls,
          f"server sub-layer calls {served_calls} != {want_calls}")

    # -- 6. times ----------------------------------------------------------
    timed = {name: (time_ms(kern), time_ms(plain))
             for name, (kern, plain) in cases.items()}
    for name, (km, pm_) in timed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")

    src8 = torch.from_numpy(vol).to(dev)

    def e2e():
        return host_seconds(lambda: predict(src8, None))

    torch.cuda.reset_peak_memory_stats()
    sec = e2e()
    peak = torch.cuda.max_memory_allocated()
    with plain_sublayers():
        sec_plain = e2e()
    print(f"{tag} e2e B={BATCH} {list(vol.shape)} bf16: kernel path "
          f"{sec * 1e3:.3f} ms = {BATCH / sec:.3f} vol/s; plain path "
          f"{sec_plain * 1e3:.3f} ms = {BATCH / sec_plain:.3f} vol/s; "
          f"peak memory (kernel path) {peak / 2**20:.1f} MiB")

    # -- 7. train kernels vs plain at the path's shapes --------------------
    print(f"{tag} train tolerance: bf16 outputs <= 2 bf16 ulps at |plain|max "
          f"(as phase 3); f32 outputs <= {KERNEL_GRAD_REL} x |plain|max for "
          f"one kernel (its sums run in another order), <= "
          f"{SUBLAYER_GRAD_REL} x for a sub-layer's chain (a bf16 rounding "
          f"that the order flips upstream moves the f32 sums after it)")
    tanh, erf = fb.ACT_GELU_TANH, fb.ACT_GELU_ERF
    g2 = rand(M, E, dtype=bf)  # upstream gradient
    qkv_t, h_t, _ = fb._ln_gemm_ref(x2, ln_s, ln_b, wqkv, bqkv, fb.ACT_NONE,
                                    eps, train=True)
    o_t, lse_t = fb._mhsa_ref(qkv_t, N_SLICES, S, HEADS, want_lse=True)
    a_t, h2_t, u_t = fb._ln_gemm_ref(x2, ln_s, ln_b, w1, b1, tanh, eps,
                                     train=True)
    do_t = fb._gemm_dgrad_ref(g2, wproj)
    dqkv_t = fb._mhsa_bwd_ref(qkv_t, o_t, do_t, lse_t, N_SLICES, S, HEADS)
    da_t = fb._gemm_dgrad_ref(g2, w2, a=a_t, act=tanh)
    ln_t = (x2, g2, ln_s, eps)
    tcases = {
        "ln_gemm_train[qkv]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2, ln_s, ln_b,
                                   wqkv, bqkv, fb.ACT_NONE, eps, True),
        "ln_gemm_train[fc1,gelu_tanh]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2,
                                             ln_s, ln_b, w1, b1, tanh, eps,
                                             True),
        "ln_gemm_train[fc1,gelu_erf]": pair(fb.ln_gemm, fb._ln_gemm_ref, x2,
                                            ln_s, ln_b, w1, b1, erf, eps,
                                            True),
        "mhsa_train": pair(fb.mhsa, fb._mhsa_ref, qkv_t, N_SLICES, S, HEADS,
                           True),
        "gemm_dls[proj]": pair(fb.gemm_dls, fb._gemm_dls_ref, o_t, wproj,
                               bproj, ls, g2),
        "gemm_dls[fc2]": pair(fb.gemm_dls, fb._gemm_dls_ref, u_t, w2, b2, ls,
                              g2),
        "gemm_wgrad[proj]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, o_t, g2),
        "gemm_wgrad[qkv]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, h_t,
                                dqkv_t),
        "gemm_wgrad[fc2]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, u_t, g2),
        "gemm_wgrad[fc1]": pair(fb.gemm_wgrad, fb._gemm_wgrad_ref, h2_t,
                                da_t),
        "gemm_dgrad[proj]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, g2,
                                 wproj),
        "gemm_dgrad[fc2,gelu_tanh]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                          g2, w2, a_t, tanh),
        "gemm_dgrad[fc2,gelu_erf]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref,
                                         g2, w2, a_t, erf),
        "gemm_dgrad[qkv,ln]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, dqkv_t,
                                   wqkv, None, fb.ACT_NONE, ln_t),
        "gemm_dgrad[fc1,ln]": pair(fb.gemm_dgrad, fb._gemm_dgrad_ref, da_t,
                                   w1, None, fb.ACT_NONE, ln_t),
        "mhsa_bwd": pair(fb.mhsa_bwd, fb._mhsa_bwd_ref, qkv_t, o_t, do_t,
                         lse_t, N_SLICES, S, HEADS),
    }
    for name, (kern, plain) in tcases.items():
        k, pl = kern(), plain()
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"kernel {name}", k, pl,
                                   KERNEL_GRAD_REL)
    g3 = g2.reshape(N_SLICES, S, E)
    sub = {
        "attention_sublayer_train[ls]": ("attn", (ln_s, ln_b, wqkv.float(),
                                                  bqkv, wproj.float(), bproj,
                                                  ls, HEADS, eps)),
        "attention_sublayer_train[no_ls]": ("attn", (ln_s, ln_b, wqkv.float(),
                                                     bqkv, wproj.float(),
                                                     bproj, None, HEADS, eps)),
    }
    for label, lsv, approx in (("tanh,ls", ls, True), ("erf,ls", ls, False),
                               ("tanh,no_ls", None, True)):
        sub[f"mlp_sublayer_train[{label}]"] = (
            "mlp", (ln_s, ln_b, w1.float(), b1, w2.float(), b2, lsv, approx,
                    eps))
    print(f"{tag} train sub-layers: outputs (y, residuals, dx, grads) of "
          f"the kernel chain vs the same chain on the plain versions "
          f"(attention: y h qkv o lse dx dln_s dln_b dwqkv dbqkv dwproj "
          f"dbproj [dls]; MLP: y h a u dx dln_s dln_b dw1 db1 dw2 db2 [dls])")
    for name, (kind, sargs) in sub.items():
        k = train_sublayer_outputs(fb, kind, fb.KERNELS, x, sargs, g3)
        pl = train_sublayer_outputs(fb, kind, fb.PLAIN, x, sargs, g3)
        torch.cuda.synchronize()
        errs[name] = check_outputs(tag, f"sublayer {name}", k, pl,
                                   SUBLAYER_GRAD_REL)
    del qkv_t, h_t, o_t, lse_t, a_t, h2_t, u_t, do_t, dqkv_t, da_t

    # -- 8. one train step at full width -----------------------------------
    # Built by `python -m mst_tpu_torch.train`'s builders; seeded weights,
    # then O(1) LayerScale so that every block counts.
    targs = cli.parse_args(["--dataset", "Synthetic", "--batch_size",
                            str(BATCH), "--max_epochs", "2",
                            "--num_train_samples", "16", "--seed",
                            str(SEED)])
    tmodel = cli.build_model(targs)
    check(tmodel.dtype == torch.bfloat16, f"train dtype {tmodel.dtype}")
    tdm = cli.build_datamodule(targs, dev, num_samples=16,
                               shape_cdhw=(1, DEPTH_SLICES, PX, PX))
    run_dir = ROOT / "build" / "chip_smoke_run"  # gitignored
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = cli.build_trainer(targs, tdm, run_dir=run_dir)
    trainer.init_state(tmodel, seed=SEED)
    with torch.no_grad():
        for name, prm in tmodel.named_parameters():
            if name.endswith(".gamma"):
                prm.copy_(torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
                    tuple(prm.shape))).to(prm))
    batch = next(iter(tdm.train_dataloader()))
    src = batch["source"]
    tgt = torch.from_numpy(batch["target"]).to(dev, torch.long)
    check(tuple(src.shape) == (BATCH, 1, DEPTH_SLICES, PX, PX)
          and src.device == dev, f"train batch {tuple(src.shape)}")

    @contextlib.contextmanager
    def plain_train_sublayers():
        """Route the blocks' train sub-layers to the plain chain on the card."""
        saved = (layers.fused_attention_sublayer_train,
                 layers.fused_mlp_sublayer_train)
        layers.fused_attention_sublayer_train = functools.partial(
            fb.fused_attention_sublayer_train, ops=fb.PLAIN)
        layers.fused_mlp_sublayer_train = functools.partial(
            fb.fused_mlp_sublayer_train, ops=fb.PLAIN)
        try:
            yield
        finally:
            (layers.fused_attention_sublayer_train,
             layers.fused_mlp_sublayer_train) = saved

    def loss_and_grads(dtype=None):
        tmodel.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(fused_mst_logits(
            tmodel, src, None, dtype=dtype, train=True), tgt)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: q.grad.detach().clone()
                             for n, q in tmodel.named_parameters()}

    fb.reset_launch_counts()
    loss_k, grads_k = loss_and_grads()  # the main path of the train step
    step_counts, step_calls = fb.launch_counts(), fb.sublayer_calls()
    with plain_train_sublayers():
        loss_p, grads_p = loss_and_grads()
        loss_32, grads_32 = loss_and_grads(torch.float32)
    per_step = {**{k: 0 for k in fb.launch_counts()},
                "ln_gemm": 2 * n_blocks, "mhsa": n_blocks,
                "gemm_residual": 2 * n_blocks, "gemm_dls": 2 * n_blocks,
                "gemm_wgrad": 4 * n_blocks, "gemm_dgrad": 4 * n_blocks,
                "mhsa_bwd": n_blocks}
    calls_per_step = {**{k: 0 for k in fb.sublayer_calls()},
                      "fused_attention_sublayer_train": n_blocks,
                      "fused_mlp_sublayer_train": n_blocks}
    def rel_errs(grads, ref):
        """Per parameter: max |grad - ref| / max |ref|."""
        out = {}
        for name, gr in grads.items():
            check(bool(torch.isfinite(gr).all()), f"grad {name}: non-finite")
            scale = ref[name].abs().max().item()
            out[name] = ((gr - ref[name]).abs().max().item() / scale
                         if scale else 0.0)
        return out

    def summary(rel):
        worst = sorted(rel.items(), key=lambda kv: -kv[1])
        return (f"max {worst[0][1]:.6g} ({worst[0][0]}), median "
                f"{statistics.median(rel.values()):.6g}; worst five: "
                + ", ".join(f"{n}={v:.3g}" for n, v in worst[:5]))

    rel = rel_errs(grads_k, grads_p)
    rel_k32, rel_p32 = rel_errs(grads_k, grads_32), rel_errs(grads_p, grads_32)
    med_k32 = statistics.median(rel_k32.values())
    med_p32 = statistics.median(rel_p32.values())
    max_k32, max_p32 = max(rel_k32.values()), max(rel_p32.values())
    print(f"{tag} train step B={BATCH} {list(src.shape)}: loss kernel path "
          f"{loss_k:.6g}, plain path {loss_p:.6g} (|diff| "
          f"{abs(loss_k - loss_p):.6g}, limit {STEP_LOSS_TOL}), f32 plain "
          f"path {loss_32:.6g}; launches {step_counts}; sublayer calls "
          f"{step_calls}")
    print(f"{tag} train step grads, |kernel - plain| / |plain|max over "
          f"{len(rel)} parameters (limit {STEP_GRAD_REL}): {summary(rel)}")
    print(f"{tag} train step grads vs the f32 step: kernel path "
          f"{summary(rel_k32)}")
    print(f"{tag} train step grads vs the f32 step: plain path "
          f"{summary(rel_p32)}")
    print(f"{tag} train step grads vs f32, kernel / plain path: median "
          f"{med_k32 / med_p32:.4g}, max {max_k32 / max_p32:.4g} (limit "
          f"{STEP_F32_RATIO} each)")
    check(math.isfinite(loss_k), "non-finite loss")
    check(abs(loss_k - loss_p) <= STEP_LOSS_TOL,
          f"train step loss {loss_k} vs plain {loss_p}")
    check(max(rel.values()) <= STEP_GRAD_REL,
          f"grads: kernel vs plain path {max(rel.values())} > {STEP_GRAD_REL}")
    check(med_k32 <= STEP_F32_RATIO * med_p32
          and max_k32 <= STEP_F32_RATIO * max_p32,
          f"grads vs f32: kernel path {med_k32}/{max_k32}, plain path "
          f"{med_p32}/{max_p32}")
    check(step_counts == per_step, f"train launches {step_counts} != {per_step}")
    check(step_calls == calls_per_step,
          f"train sub-layer calls {step_calls} != {calls_per_step}")
    del grads_k, grads_p, grads_32

    start = {n: q.detach().clone() for n, q in tmodel.named_parameters()}

    def fit_losses():
        """FIT_STEPS AdamW steps on the one batch from `start`."""
        with torch.no_grad():
            for n, q in tmodel.named_parameters():
                q.copy_(start[n])
        step = make_train_step(TrainState(tmodel, make_optimizer(
            tmodel.parameters(), FIT_LR)))
        return [float(v) for v in [step(src, tgt)[0]
                                   for _ in range(FIT_STEPS)]]

    fit_k = fit_losses()
    with plain_train_sublayers():
        fit_p = fit_losses()
    track = max(abs(a - b) for a, b in zip(fit_k, fit_p))
    print(f"{tag} fit one batch, {FIT_STEPS} AdamW steps at lr {FIT_LR}: "
          f"kernel path {[round(v, 5) for v in fit_k]}, plain path "
          f"{[round(v, 5) for v in fit_p]}; max |kernel - plain| "
          f"{track:.6g} (limit {FIT_TRACK_TOL}); fall {fit_k[0] / fit_k[-1]:.4g}x "
          f"(must be >= {FIT_DROP}x)")
    check(fit_k[-1] * FIT_DROP <= fit_k[0], f"loss fell only {fit_k}")
    check(track <= FIT_TRACK_TOL, f"kernel path leaves the plain path: {track}")

    # -- 9. the trainer end to end, and the checkpoint it writes, served ---
    tdm.set_epoch(0)
    state, result = cli.train(targs, tmodel, tdm, trainer)
    hist = [json.loads(line) for line in
            (run_dir / "history.jsonl").read_text().splitlines()]
    best_npz = best_params_path(run_dir)
    print(f"{tag} trainer: {result.epochs_run} epochs, best val/AUC_ROC "
          f"{result.best_metric:.4g} @ epoch {result.best_epoch}, "
          f"{state.step} steps; history {[{k: v for k, v in r.items() if not k.startswith('perf/')} for r in hist]}; "
          f"files {sorted(q.name for q in run_dir.iterdir())}")
    check(result.epochs_run == 2 and len(hist) == 2, "two epochs")
    check(all(math.isfinite(r["train_loss"]) for r in hist), "train loss")
    check(best_npz.exists() and (run_dir / "best_checkpoint.json").exists()
          and best_npz.parent.name == f"epoch={result.best_epoch}",
          f"best checkpoint {best_npz}")
    check(len(list(run_dir.glob("epoch=*/"))) == 1, "top-1 policy")
    served = build_model(parse_args(["--params_npz", str(best_npz)]))
    vbatch = next(iter(tdm.val_dataloader()))
    p_served, _ = make_predict_fn(served, with_saliency=False)(
        vbatch["source"], None)
    with np.load(best_npz) as z:
        params_from_flax(tmodel, {k: z[k] for k in z.files})
    p_eval = torch.softmax(make_eval_step(tmodel)(vbatch["source"]).float(),
                           -1)
    d_ck = (p_served - p_eval).abs().max().item()
    print(f"{tag} trainer: the served best checkpoint's probs vs the eval "
          f"step's on {tuple(vbatch['source'].shape)} val volumes: max |diff| "
          f"{d_ck:.6g} (must be 0: the same weights through the same kernels)")
    check(d_ck == 0.0, f"served checkpoint differs from the eval step: {d_ck}")
    del served

    # -- 10. train times ----------------------------------------------------
    ttimed = {name: (time_ms(kern), time_ms(plain))
              for name, (kern, plain) in tcases.items()}
    for name, (km, pm_) in ttimed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")
    for name, (kind, sargs) in sub.items():
        fn = (fb.fused_attention_sublayer_train if kind == "attn"
              else fb.fused_mlp_sublayer_train)
        for label, ops in (("kernel", fb.KERNELS), ("plain", fb.PLAIN)):
            ms = time_ms(lambda: fn(x.detach().requires_grad_(True), *sargs,
                                    ops=ops).backward(g3), n=5)
            print(f"{tag} time {name} forward + backward: {label} "
                  f"{ms:.4f} ms")

    def step_seconds():
        step = make_train_step(TrainState(tmodel, make_optimizer(
            tmodel.parameters(), 0.0)))  # lr 0: same work, same weights
        return host_seconds(lambda: step(src, tgt)), step

    torch.cuda.reset_peak_memory_stats()
    sec_t, kstep = step_seconds()
    peak_t = torch.cuda.max_memory_allocated()
    with plain_train_sublayers():
        sec_tp, _ = step_seconds()
    print(f"{tag} train step B={BATCH} {list(src.shape)} bf16 (forward, CE, "
          f"backward, AdamW): kernel path {sec_t * 1e3:.3f} ms = "
          f"{BATCH / sec_t:.3f} vol/s; plain sub-layers {sec_tp * 1e3:.3f} "
          f"ms = {BATCH / sec_tp:.3f} vol/s; peak memory (kernel path) "
          f"{peak_t / 2**20:.1f} MiB")
    profile_device(tag, "one train step", lambda: kstep(src, tgt), 16)

    # -- 11. saliency kernels vs plain at the path's shapes ----------------
    print(f"{tag} saliency kernel tolerance: bf16 outputs <= 2 bf16 ulps, "
          f"f32 outputs (CLS row, carry, Abnar factor) <= {KERNEL_GRAD_REL} "
          f"x |plain|max for one kernel, <= {SUBLAYER_GRAD_REL} x for a "
          f"sub-layer chain (as phase 7); every kernel repeats bit for bit")
    e0 = torch.zeros(N_SLICES, HEADS, S, device=dev)
    e0[:, :, 0] = 1.0  # the rollout chain starts at the CLS token
    c1_plain = fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, carry=e0)[1]

    xb = rand(N_SLICES, S, E, dtype=bf)  # the second block's input

    def rollout2(fn):
        """Two blocks of the rollout sub-layer, the second fed the first's
        carry (not one-hot) on an input of its own."""
        y1, c1 = fn(*attn_args, ls, e0, HEADS, eps)
        return (y1, c1, *fn(xb, *attn_args[1:], ls, c1, HEADS, eps,
                            want_row=True))

    scases = {
        "mhsa_with_row": (lambda: fb.mhsa_with_row(qkv_in, N_SLICES, S, HEADS),
                          lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS,
                                               want_row=True)),
        "mhsa_rollout[block0]": (
            lambda: fb.mhsa_rollout(qkv_in, e0, N_SLICES, S, HEADS),
            lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, carry=e0)),
        "mhsa_rollout[block1,row]": (
            lambda: fb.mhsa_rollout(qkv_in, c1_plain, N_SLICES, S, HEADS,
                                    want_row=True),
            lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS, want_row=True,
                                 carry=c1_plain)),
        "mhsa_abnar": (lambda: fb.mhsa_abnar(qkv_in, N_SLICES, S, HEADS),
                       lambda: fb._mhsa_ref(qkv_in, N_SLICES, S, HEADS,
                                            want_abnar=True)),
    }
    ssub = {
        "attention_sublayer_with_row[ls]": pair(
            fb.fused_attention_sublayer_with_row, fb._attn_with_row_ref,
            *attn_args, ls, HEADS),
        "attention_sublayer_rollout[ls,2 blocks]": (
            lambda: rollout2(fb.fused_attention_sublayer_rollout),
            lambda: rollout2(fb._attn_rollout_ref)),
        "attention_sublayer_abnar[ls]": pair(
            fb.fused_attention_sublayer_abnar, fb._attn_abnar_ref,
            *attn_args, ls, HEADS),
        "attention_sublayer_abnar[no_ls]": pair(
            fb.fused_attention_sublayer_abnar, fb._attn_abnar_ref,
            *attn_args, None, HEADS),
    }
    with torch.inference_mode():
        for name, (kern, plain) in {**scases, **ssub}.items():
            k, pl = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            rel = KERNEL_GRAD_REL if name in scases else SUBLAYER_GRAD_REL
            errs[name] = check_outputs(tag, f"saliency {name}", k, pl, rel)
            same = all(torch.equal(a, b) for a, b in zip(k, again))
            print(f"{tag} saliency {name}: two runs equal bit for bit: {same}")
            check(same, f"{name}: two runs differ")
        del k, pl, again

    # -- 12. the saliency forward at B=8 (each mode: counts read around it) -
    mask_t = torch.from_numpy(mask).to(dev)
    n_full = n_blocks + 1  # rollout / abnar run block 11 on the kernels too
    zero = {k: 0 for k in fb.launch_counts()}
    zero_calls = {k: 0 for k in fb.sublayer_calls()}

    def per_forward(mode):
        """(launches, sub-layer calls) of one saliency forward."""
        if mode == "last":
            return per_fwd, calls_per_fwd
        attn = {"rollout": "rollout", "rollout_abnar": "abnar"}[mode]
        return ({**zero, "ln_gemm": 2 * n_full, "gemm_residual": 2 * n_full,
                 f"mhsa_{attn}": n_full},
                {**zero_calls, f"fused_attention_sublayer_{attn}": n_full,
                 "fused_mlp_sublayer": n_full})

    def saliency(mode, m=None, dtype=None):
        with torch.inference_mode():
            out = fused_mst_saliency(model, src8, m, dtype=dtype,
                                     plane_mode=mode)
        torch.cuda.synchronize()
        return out

    def sal_rel(a, b):
        """max |a - b| relative to b's largest value."""
        return (a - b).abs().max().item() / b.abs().max().item()

    print(f"{tag} saliency tolerance: probs as phase 4; a saliency map within "
          f"{SAL_REL} of the plain path's largest value, {SAL_F32_REL} of the "
          f"f32 plain path's (bf16 rounding through 12 blocks of a "
          f"random-weight ViT-S moves a CLS attention row by a few percent)")
    sal_counts = {}
    for mode in PLANE_MODES:
        for label, m in (("no mask", None), ("key-padding mask", mask_t)):
            fb.reset_launch_counts()
            pk, sk = saliency(mode, m)
            counts, calls = fb.launch_counts(), fb.sublayer_calls()
            with plain_sublayers():
                pp, sp_ = saliency(mode, m)
                p32, s32 = saliency(mode, m, torch.float32)
            check(tuple(sk.shape) == (BATCH, DEPTH_SLICES, PX, PX)
                  and sk.dtype == torch.float32, f"saliency {tuple(sk.shape)}")
            check(bool(torch.isfinite(sk).all() and torch.isfinite(pk).all()),
                  f"{mode}: non-finite output")
            d_p, d_p32 = ((pk - pp).abs().max().item(),
                          (pk - p32).abs().max().item())
            d_s, d_s32 = sal_rel(sk, sp_), sal_rel(sk, s32)
            d_fwd = (pk - predict(src8, m)[0]).abs().max().item()
            print(f"{tag} saliency {mode} [{label}] {list(sk.shape)}: "
                  f"|probs - plain| {d_p:.6g}, |probs - f32| {d_p32:.6g}, "
                  f"|probs - forward without saliency| {d_fwd:.6g}; saliency "
                  f"vs plain {d_s:.6g}, vs f32 {d_s32:.6g} (of the largest "
                  f"value {sp_.abs().max().item():.6g}); plain vs f32 "
                  f"{sal_rel(sp_, s32):.6g}; launches {counts}; sub-layer "
                  f"calls {calls}")
            check(d_p <= PROB_TOL and d_p32 <= F32_TOL,
                  f"{mode} probs: {d_p} / {d_p32}")
            check(d_s <= SAL_REL and d_s32 <= SAL_F32_REL,
                  f"{mode} saliency: {d_s} / {d_s32}")
            if mode == "last":  # the same kernels as the forward without
                check(d_fwd <= 1e-6, f"last-mode probs moved by {d_fwd}")
            if m is not None:  # padded slices get no slice attention
                pad = max(sk[1, 24:].abs().max().item(),
                          sk[5, 30:].abs().max().item())
                check(pad == 0.0, f"{mode}: padded slices' saliency {pad}")
            want, want_calls = per_forward(mode)
            check(counts == want, f"{mode} launches {counts} != {want}")
            check(calls == want_calls, f"{mode} calls {calls} != {want_calls}")
            sal_counts[mode] = counts
    del pp, sp_, p32, s32
    # MST_NO_CHEAP_LAST: block 11 in full, its row from the with_row kernel
    os.environ["MST_NO_CHEAP_LAST"] = "1"
    try:
        fb.reset_launch_counts()
        p_full, s_full = saliency("last")
        full_counts, full_calls = fb.launch_counts(), fb.sublayer_calls()
    finally:
        del os.environ["MST_NO_CHEAP_LAST"]
    p_cheap, s_cheap = saliency("last")
    d_p, d_s = (p_full - p_cheap).abs().max().item(), sal_rel(s_full, s_cheap)
    want = {**per_fwd, "ln_gemm": 2 * n_full, "gemm_residual": 2 * n_full,
            "mhsa_with_row": 1}
    want_calls = {**calls_per_fwd, "fused_attention_sublayer_with_row": 1,
                  "fused_mlp_sublayer": n_full}
    print(f"{tag} saliency last, MST_NO_CHEAP_LAST=1 vs the CLS-only last "
          f"block: |probs| {d_p:.6g}, saliency {d_s:.6g} (limit "
          f"{SAL_CHEAP_REL}); launches {full_counts}; sub-layer calls "
          f"{full_calls}")
    check(d_p <= PROB_TOL and d_s <= SAL_CHEAP_REL,
          f"MST_NO_CHEAP_LAST: probs {d_p}, saliency {d_s}")
    check(full_counts == want, f"launches {full_counts} != {want}")
    check(full_calls == want_calls, f"calls {full_calls} != {want_calls}")
    sal_counts["with_row"] = full_counts
    del p_full, s_full, p_cheap, s_cheap

    # -- 13. the predict CLI on phase 9's run folder ------------------------
    out_dir = ROOT / "build" / "chip_smoke_predict"  # gitignored
    shutil.rmtree(out_dir, ignore_errors=True)
    data_kw = dict(shape_cdhw=(1, DEPTH_SLICES, PX, PX), num_samples=N_CASES)
    pargv = ["--run_folder", str(run_dir), "--output_dir", str(out_dir),
             "--use_tta", "--use_rollout", "--save_saliency"]
    fb.reset_launch_counts()
    t1 = time.perf_counter()
    predict_cli.main(pargv, **data_kw)
    torch.cuda.synchronize()
    cli_sec = time.perf_counter() - t1
    cli_counts, cli_calls = fb.launch_counts(), fb.sublayer_calls()
    with (out_dir / "results.csv").open() as f:
        rows = list(csv.DictReader(f))
    pargs = predict_cli.parse_args(pargv)
    pmodel = predict_cli.build_model(pargs, dev)
    pfn = make_predict_fn(pmodel, tta=True, plane_mode="rollout")
    worst_p = worst_s = 0.0
    batches = predict_cli.build_datamodule(pargs, dev, **data_kw)
    for r, b in zip(rows, batches.test_dataloader()):
        pb, sb = pfn(b["source"], None)
        check(r["uid"] == b["uid"][0] and int(r["GT"]) == int(b["target"][0]),
              f"row {r} is not case {b['uid'][0]}")
        check(int(r["NN"]) == int(pb[0].argmax()), f"NN of {r['uid']}")
        worst_p = max(worst_p, abs(float(r["NN_pred"]) - pb[0, 1].item()))
        got = read_nifti_f32(out_dir / f"case_{r['uid']}" / "saliency.nii.gz")
        want_s = sb[0].cpu().numpy().transpose(2, 1, 0)
        check(got.shape == want_s.shape, f"NIfTI {got.shape}")
        worst_s = max(worst_s, float(np.abs(got - want_s).max()
                                     / np.abs(want_s).max()))
    log_text = (out_dir / "predict.log").read_text()
    t1 = time.perf_counter()
    write_nifti(out_dir / "timing.nii.gz", got)
    sec_nii = time.perf_counter() - t1
    t1 = time.perf_counter()
    write_nifti(out_dir / "timing.nii.gz", b["source"][0, 0].cpu().numpy())
    sec_nii_in = time.perf_counter() - t1
    print(f"{tag} predict CLI --use_tta --use_rollout --save_saliency on "
          f"{N_CASES} cases {list(data_kw['shape_cdhw'])}: {cli_sec:.3f} s "
          f"(one saliency.nii.gz write {sec_nii:.3f} s, one input.nii.gz "
          f"write {sec_nii_in:.3f} s); "
          f"launches {cli_counts}; results.csv vs the predictor: |NN_pred| "
          f"{worst_p:.6g}, saliency.nii.gz {worst_s:.6g} (both must be <= "
          f"1e-6: the same kernels on the same batches); predict.log: "
          f"{log_text.strip().splitlines()}")
    check(len(rows) == N_CASES, f"{len(rows)} result rows")
    check(worst_p <= 1e-6 and worst_s <= 1e-6,
          f"CLI vs predictor: {worst_p} / {worst_s}")
    check("AUC=" in log_text and "Youden point" in log_text, "predict.log")
    want = {**zero, "ln_gemm": 2 * n_full * N_CASES,
            "mhsa_rollout": n_full * N_CASES,
            "gemm_residual": 2 * n_full * N_CASES}
    check(cli_counts == want, f"CLI launches {cli_counts} != {want}")
    del pmodel, pfn

    # -- 14. saliency times ---------------------------------------------------
    # plain-flags `mhsa` and its sub-layer again, beside them in time
    reference = {"mhsa[plain flags]": cases["mhsa"],
                 "attention_sublayer[ls,plain flags]":
                     cases["attention_sublayer[ls]"]}
    with torch.inference_mode():
        stimed = {name: (time_ms(kern), time_ms(plain)) for name, (kern, plain)
                  in {**reference, **scases, **ssub}.items()}
    for name, (km, pm_) in stimed.items():
        print(f"{tag} time {name}: kernel {km:.4f} ms, plain {pm_:.4f} ms")
    def seconds_and_memory(fn):
        """(median seconds of fn, its peak device memory above what was
        held before it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        sec_ = host_seconds(fn)
        return sec_, torch.cuda.max_memory_allocated() - held

    sec_fwd, mem_fwd = seconds_and_memory(lambda: predict(src8, None))
    print(f"{tag} e2e B={BATCH} {list(vol.shape)} bf16 without saliency: "
          f"{sec_fwd * 1e3:.3f} ms = {BATCH / sec_fwd:.3f} vol/s, peak "
          f"memory {mem_fwd / 2**20:.1f} MiB above the "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB held")
    vol1 = src8[:1]
    for mode in PLANE_MODES:
        sec_m, mem_m = seconds_and_memory(lambda: saliency(mode))
        tta = make_predict_fn(model, tta=True, plane_mode=mode)
        sec_1 = host_seconds(lambda: tta(vol1, None))
        print(f"{tag} e2e saliency {mode} B={BATCH}: {sec_m * 1e3:.3f} ms = "
              f"{BATCH / sec_m:.3f} vol/s ({sec_m / sec_fwd:.3f}x the forward "
              f"without saliency), peak memory {mem_m / 2**20:.1f} MiB above "
              f"what was held; batch-1 8-flip TTA with saliency: "
              f"{sec_1 * 1e3:.3f} ms per volume")
        profile_device(tag, f"one B={BATCH} saliency forward ({mode})",
                       lambda: saliency(mode), 8)

    # TPU kernels: _attn_any_kernel at fused_block.py:326, _mlp_kernel at
    # :400, their train forwards _attn_train_kernel :424 and
    # _mlp_train_kernel :470, the backwards _attn_bwd_kernel :680 and
    # _mlp_bwd_kernel :841. Each CUDA kernel replaces a part of several.
    site = "mst_tpu/ops/fused_block.py:{}".format
    fwd_sites = [site(326), site(400), site(424), site(470)]
    bwd_sites = [site(680), site(841)]
    sites = {
        # name: (source, replaces, launches of its main path, timed cases)
        "ln_gemm": ("ln_gemm", fwd_sites, served_counts,
                    ["ln_gemm[qkv]", "ln_gemm[fc1,gelu_tanh]"]),
        "mhsa": ("mhsa", [site(326), site(424)], served_counts, ["mhsa"]),
        "gemm_residual": ("gemm_residual", fwd_sites, served_counts,
                          ["gemm_residual[proj,ls]", "gemm_residual[fc2,ls]"]),
        "gemm_dls": ("gemm_residual", bwd_sites, step_counts,
                     ["gemm_dls[proj]", "gemm_dls[fc2]"]),
        "gemm_wgrad": ("gemm_wgrad", bwd_sites, step_counts,
                       ["gemm_wgrad[proj]", "gemm_wgrad[qkv]",
                        "gemm_wgrad[fc2]", "gemm_wgrad[fc1]"]),
        "gemm_dgrad": ("gemm_dgrad", bwd_sites, step_counts,
                       ["gemm_dgrad[proj]", "gemm_dgrad[fc2,gelu_tanh]",
                        "gemm_dgrad[qkv,ln]", "gemm_dgrad[fc1,ln]"]),
        "mhsa_bwd": ("mhsa_bwd", [site(680)], step_counts, ["mhsa_bwd"]),
        # the saliency outputs of `mhsa` (flags of _attn_any_kernel), each
        # counted in the forward of the plane mode that runs it (phase 12)
        "mhsa_with_row": ("mhsa", [site(1479)], sal_counts["with_row"],
                          ["mhsa_with_row"]),
        "mhsa_rollout": ("mhsa", [site(1535)], sal_counts["rollout"],
                         ["mhsa_rollout[block1,row]"]),
        "mhsa_abnar": ("mhsa", [site(1503)], sal_counts["rollout_abnar"],
                       ["mhsa_abnar"]),
    }
    alltimed = {**timed, **ttimed, **stimed}
    kernels = []
    for name, (source, replaces, counts, per_block) in sites.items():
        checked = [c for c in errs if c.split("[")[0] in
                   (name, name + "_train")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mst_tpu_torch/csrc/{source}.cu",
            "replaces": replaces[0], "also_replaces": replaces[1:],
            "launches": counts[name],
            "launches_per_train_step": step_counts[name],
            "max_abs_err": max(errs[c] for c in checked),
            # one ViT-S block's calls of this kernel at B=8 (serving
            # forward for ln_gemm, mhsa, gemm_residual and the saliency
            # outputs, train backward for the rest)
            "ms": sum(alltimed[c][0] for c in per_block),
            "plain_ms": sum(alltimed[c][1] for c in per_block),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
