#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on an NVIDIA GPU.

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
   vol/s at B=8, peak device memory.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Any failed check raises (exit code != 0).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
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


def main() -> int:
    if not (ROOT / "mst_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (mst_tpu_torch/csrc not found)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))

    from mst_tpu_torch.models import layers
    from mst_tpu_torch.models.convert import random_flax_params
    from mst_tpu_torch.models.vit_fast import fused_mst_logits
    from mst_tpu_torch.ops import _build
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import MODEL, build_model, build_server, parse_args
    from mst_tpu_torch.train.predictor import make_predict_fn

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
    predict = make_predict_fn(model)
    vol = spread_volumes(rng, predict, BATCH)
    mask = np.zeros((BATCH, DEPTH_SLICES), bool)
    mask[1, 24:] = True  # volume 1: its last 8 slices are padding
    mask[5, 30:] = True

    @contextlib.contextmanager
    def plain_sublayers():
        """Route the blocks through the plain versions on the card."""
        saved = layers.fused_attention_sublayer, layers.fused_mlp_sublayer
        layers.fused_attention_sublayer = fb._attn_ref
        layers.fused_mlp_sublayer = fb._mlp_ref
        try:
            yield
        finally:
            layers.fused_attention_sublayer, layers.fused_mlp_sublayer = saved

    print(f"{tag} forward tolerance: |probs kernel - probs plain| <= "
          f"{PROB_TOL} (bf16 roundings flipped by the summation order "
          f"compound over 11 blocks of a random-weight ViT-S)")
    n_blocks = 11  # block 11 is the CLS-only plain block
    per_fwd = {"ln_gemm": 2 * n_blocks, "mhsa": n_blocks,
               "gemm_residual": 2 * n_blocks}
    calls_per_fwd = {"fused_attention_sublayer": n_blocks,
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

    def e2e(n=5):
        predict(src8, None)
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t1 = time.perf_counter()
            predict(src8, None)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t1)
        return statistics.median(ts)

    torch.cuda.reset_peak_memory_stats()
    sec = e2e()
    peak = torch.cuda.max_memory_allocated()
    with plain_sublayers():
        sec_plain = e2e()
    print(f"{tag} e2e B={BATCH} {list(vol.shape)} bf16: kernel path "
          f"{sec * 1e3:.3f} ms = {BATCH / sec:.3f} vol/s; plain path "
          f"{sec_plain * 1e3:.3f} ms = {BATCH / sec_plain:.3f} vol/s; "
          f"peak memory (kernel path) {peak / 2**20:.1f} MiB")

    # TPU kernels: _attn_any_kernel at fused_block.py:326, _mlp_kernel at
    # :400. ln_gemm and gemm_residual each replace a part of both.
    attn_site, mlp_site = ("mst_tpu/ops/fused_block.py:326",
                           "mst_tpu/ops/fused_block.py:400")
    sites = {
        "ln_gemm": ([attn_site, mlp_site],
                    ["ln_gemm[qkv]", "ln_gemm[fc1,gelu_tanh]"]),
        "mhsa": ([attn_site], ["mhsa"]),
        "gemm_residual": ([attn_site, mlp_site],
                          ["gemm_residual[proj,ls]", "gemm_residual[fc2,ls]"]),
    }
    kernels = []
    for name, (replaces, per_block) in sites.items():
        checked = [c for c in cases if c.startswith(name + "[") or c == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mst_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[0], "also_replaces": replaces[1:],
            "launches": served_counts[name],
            "max_abs_err": max(errs[c] for c in checked),
            # one ViT-S block's calls of this kernel at B=8
            "ms": sum(timed[c][0] for c in per_block),
            "plain_ms": sum(timed[c][1] for c in per_block),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
