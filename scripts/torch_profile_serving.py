#!/usr/bin/env python
"""Where the time goes in the PyTorch port's serving forward on a CUDA card.

    python scripts/torch_profile_serving.py [--batch 8] [--out DIR]

Builds ViT-S/14 MST-DINOv2 with seeded random weights (O(1) LayerScale),
then on [batch, 1, 32, 224, 224] bf16:

- traces one forward with `torch.profiler` and prints the device time per
  kernel name, the device-busy time and its share of the forward's wall
  time (the rest is the card idling on the host); the Chrome trace and the
  full table go to DIR;
- times each fused sub-layer at the path shape ([8*32, 257, 384]) three
  ways with CUDA events (median of 20): the hand-written kernels, their
  plain versions, and a library composition in bf16 (F.layer_norm, cuBLAS
  GEMMs, F.scaled_dot_product_attention) that shows how far the kernels are
  from library speed. The library composition is a yardstick only; it is
  not on any path of the port.

Needs a CUDA device; every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import time_ms  # noqa: E402
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params  # noqa: E402
from mst_tpu_torch.models.mst import dino_v2_classifier_slice  # noqa: E402
from mst_tpu_torch.ops import fused_block as fb  # noqa: E402
from mst_tpu_torch.train.predictor import make_predict_fn  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "torch_profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")[0]
    tag = f"[{smi.strip()}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(0)
    model = dino_v2_classifier_slice(out_ch=2, dtype=torch.bfloat16)
    flat = random_flax_params(model, 0)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    model = params_from_flax(model, flat).to(dev).eval()
    predict = make_predict_fn(model, with_saliency=False)
    src = torch.from_numpy(rng.standard_normal(
        (args.batch, 1, 32, 224, 224)).astype(np.float32)).to(dev)

    # -- one traced forward ------------------------------------------------
    for _ in range(2):
        predict(src)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        predict(src)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out_dir / "forward_trace.json"))
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    table = "\n".join(f"{ms:10.3f} ms {n:5d}x  {key}" for ms, n, key in rows)
    (out_dir / "forward_kernels.txt").write_text(
        f"{tag} B={args.batch} wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms\n{table}\n")
    print(f"{tag} traced forward B={args.batch}: wall {wall_ms:.3f} ms "
          f"(profiler on), device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    for ms, n, key in rows[:15]:
        print(f"{tag}   {ms:9.3f} ms {100 * ms / busy_ms:6.2f}% {n:4d}x "
              f"{key[:110]}")

    # -- sub-layers: kernels vs plain vs library ----------------------------
    n_sl, s, e, heads = 32 * args.batch, 257, 384, 6
    blk = model.encoder.block(0)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((n_sl, s, e)).astype(
        np.float32)).to(dev, bf)
    a = (blk.norm1.scale, blk.norm1.bias, blk.attn.qkv.kernel.to(bf),
         blk.attn.qkv.bias, blk.attn.proj.kernel.to(bf), blk.attn.proj.bias,
         blk.ls1.gamma)
    m = (blk.norm2.scale, blk.norm2.bias, blk.mlp.fc1.kernel.to(bf),
         blk.mlp.fc1.bias, blk.mlp.fc2.kernel.to(bf), blk.mlp.fc2.bias,
         blk.ls2.gamma)
    lib_a = [t.to(bf) for t in a]
    lib_m = [t.to(bf) for t in m]

    def lib_attn():
        ln_s, ln_b, wqkv, bqkv, wp, bp, ls = lib_a
        h = F.layer_norm(x, (e,), ln_s, ln_b, 1e-6)
        qkv = (h @ wqkv + bqkv).reshape(n_sl, s, 3, heads, e // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return x + (o.transpose(1, 2).reshape(n_sl, s, e) @ wp + bp) * ls

    def lib_mlp():
        ln_s, ln_b, w1, b1, w2, b2, ls = lib_m
        h = F.gelu(F.layer_norm(x, (e,), ln_s, ln_b, 1e-6) @ w1 + b1,
                   approximate="tanh")
        return x + (h @ w2 + b2) * ls

    with torch.inference_mode():
        for name, kern, plain, lib in (
                ("attention_sublayer",
                 lambda: fb.fused_attention_sublayer(x, *a, heads),
                 lambda: fb._attn_ref(x, *a, heads), lib_attn),
                ("mlp_sublayer",
                 lambda: fb.fused_mlp_sublayer(x, *m, True),
                 lambda: fb._mlp_ref(x, *m, True), lib_mlp)):
            print(f"{tag} {name} [{n_sl}, {s}, {e}] bf16: kernels "
                  f"{time_ms(kern):.4f} ms, plain {time_ms(plain):.4f} ms, "
                  f"library bf16 {time_ms(lib):.4f} ms")


if __name__ == "__main__":
    main()
