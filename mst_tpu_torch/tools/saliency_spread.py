"""How far the saliency maps of the kernel paths lie from the plain paths',
over several seeded weight draws: ViT-S/14 in bf16 and in W8A8 int8 with
per-token (dynamic) and calibrated (static) scales.

`chip_smoke.py` phase 32 held the int8 kernel path's saliency to the plain
int8 path's within 0.05 of its largest value (the bf16 limit) until that
limit proved to lie inside the spread: the distance comes from bf16
roundings that a change of summation order flips, which static int8 codes
then move by whole steps through 11 blocks; so it is a spread over draws,
not a bias of one kernel. Phase 32 now holds the kernel path against the
oracle, the plain int8 path in f64: its distance from it at most 1.5 times
the bf16 plain int8 path's (`SAL_I8_RATIO`), each distance pooled over
the batch (each volume's max |saliency - oracle| relative to that volume's
largest oracle value, averaged over the volumes). This reads both rules on
`--draws` draws (LayerScale 1 + 0.1 N(0, 1), as phase 4), each static copy
calibrated on 8 volumes of the generator of the 8 volumes read, in the
`last` and `rollout` plane modes: the kernel-vs-plain distance, and for
the int8 paths the ratio of the kernel path's and the plain path's pooled
distances from the oracle ("ratio") beside the ratio of the batch's worst
volume's distances, the rule's first statistic ("worst-volume ratio").

    python mst_tpu_torch/tools/saliency_spread.py [--root CHECKOUT]
        [--draws 6] [--json OUT]

`--root` imports `mst_tpu_torch` from another checkout (an earlier commit
unpacked with `git archive`), so that two commits' kernel paths are read
on the same draws and volumes; the plain paths are the same code in both.
Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCH, DEPTH, PX = 8, 32, 224
MODES = ("last", "rollout")
RATIO = 1.5  # chip_smoke.SAL_I8_RATIO


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose mst_tpu_torch is measured")
    ap.add_argument("--draws", type=int, default=6)
    ap.add_argument("--json", default=None, help="write the readings")
    return ap.parse_args(argv)


def volumes(rng, n: int) -> np.ndarray:
    """n seeded [1, D, H, W] volumes, each noise of its own scale, offset and
    56-pixel block pattern (`chip_smoke.candidate_volumes`)."""
    f32, one = np.float32, (n, 1, 1, 1, 1)
    v = rng.standard_normal((n, 1, DEPTH, PX, PX), dtype=f32)
    v *= rng.uniform(0.25, 2.0, one).astype(f32)
    v += rng.uniform(-1.5, 1.5, one).astype(f32)
    blocks = rng.standard_normal((n, 1, DEPTH, 4, 4), dtype=f32)
    blocks *= rng.uniform(0.0, 2.0, one).astype(f32)
    return v + np.repeat(np.repeat(blocks, PX // 4, axis=3), PX // 4, axis=4)


@contextlib.contextmanager
def routed(module, table):
    """Set `module`'s attributes from `table` for the block."""
    saved = {k: getattr(module, k) for k in table}
    for k, fn in table.items():
        setattr(module, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


def main(argv=None) -> list:
    """Print each draw's readings, then each path and mode's range over the
    draws; returns the readings, one {"<path>/<mode>": rel} per draw."""
    if not torch.cuda.is_available():
        raise RuntimeError("saliency_spread runs on a CUDA device; "
                           "torch.cuda.is_available() is False")
    args = parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.models.convert import random_flax_params
    from mst_tpu_torch.models.vit_fast import fused_mst_saliency
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.ops import fused_int8 as fq
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.serve import build_model, parse_args as serve_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0] + "]"
    plain = {"fused_attention_sublayer": fb._attn_ref,
             "fused_mlp_sublayer": fb._mlp_ref,
             "fused_attention_sublayer_with_row": fb._attn_with_row_ref,
             "fused_attention_sublayer_rollout": fb._attn_rollout_ref,
             "fused_attention_sublayer_i8": fq._attn_i8_ref,
             "fused_mlp_sublayer_i8": fq._mlp_i8_ref}

    def saliency(mdl, vols, mode, dtype=None):
        with torch.inference_mode():
            out = fused_mst_saliency(mdl, vols, None, dtype=dtype,
                                     plane_mode=mode)[1]
        torch.cuda.synchronize()
        return out

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def pooled(a, b):  # chip_smoke.py phase 32's `sal_pooled`
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        return ((a - b).abs().amax(1) / b.abs().amax(1)).mean().item()

    npz_dir = Path(__file__).resolve().parents[2] / "build"  # gitignored
    npz_dir.mkdir(parents=True, exist_ok=True)
    readings = []
    for draw in range(args.draws):
        rng = np.random.default_rng(100 + draw)
        flat = random_flax_params(get_model("DinoV2ClassifierSlice"), draw)
        for key in flat:
            if key.endswith("/gamma"):
                flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                             ).astype(np.float32)
        npz = npz_dir / f"saliency_spread_{draw}.npz"
        np.savez(npz, **flat)
        model = build_model(serve_args(["--params_npz", str(npz)]))
        pool = volumes(rng, 2 * BATCH)
        paths = {"bf16": model,
                 "int8 dynamic": build_model(serve_args(
                     ["--params_npz", str(npz), "--int8"])),
                 "int8 static": fq.quantize_mst_int8(model, pool[:BATCH])}
        vols = torch.from_numpy(pool[BATCH:]).to(dev)
        row = {}
        for label, mdl in paths.items():
            for mode in MODES:
                k = saliency(mdl, vols, mode)
                with routed(layers, plain):
                    p = saliency(mdl, vols, mode)
                    o = (saliency(mdl, vols, mode, torch.float64)
                         if label != "bf16" else None)
                row[f"{label}/{mode}"] = rel(k, p)
                if o is not None:  # the oracle rule's ratios
                    row[f"{label}/{mode} ratio"] = (pooled(k, o)
                                                    / pooled(p, o))
                    row[f"{label}/{mode} worst-volume ratio"] = (
                        rel(k, o) / rel(p, o))
        readings.append(row)
        npz.unlink()
        print(f"{tag} {root.name} draw {draw}: saliency vs plain, relative "
              f"to its largest value: "
              + ", ".join(f"{k} {v:.4g}" for k, v in row.items()))
    for key in readings[0]:
        vals = [r[key] for r in readings]
        lim = RATIO if key.endswith("ratio") else 0.05
        print(f"{tag} {root.name} {key}: {min(vals):.4g}-{max(vals):.4g} over "
              f"{len(vals)} draws, {sum(v > lim for v in vals)} above {lim}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(readings))
    return readings


if __name__ == "__main__":
    main()
