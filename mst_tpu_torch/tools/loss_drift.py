"""How far the frozen giant2 step's loss on the kernels lies from the plain
path's, batch by batch, and how far it moves when only the LN half of
`ln_gemm` / `ln_gemm_swiglu` (`ln_rows`) takes its plain version.

`chip_smoke.py` phase 24 holds the mean |loss kernel - plain| over 8
batches to a limit of 0.01. A random-weight giant2 has 40 blocks, and a
bf16 rounding flipped by any change in the f32 summation order grows
through them, so that distance is set by which roundings flip, not by a
bias of one kernel. This measures it on one seeded draw (LayerScale
1 + 0.1 N(0, 1), as phase 22) over `--batches` val batches of Synthetic
[8, 1, 32, 224, 224] volumes.

    python mst_tpu_torch/tools/loss_drift.py [--root CHECKOUT]
        [--batches 16] [--json OUT]

`--root` imports `mst_tpu_torch` from another checkout (an earlier commit
unpacked with `git archive`), so that two commits' kernel paths are read
on the same draw and batches; the plain path is the same code in both.
Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose mst_tpu_torch is measured")
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write the per-batch losses")
    return ap.parse_args(argv)


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


def main(argv=None) -> dict:
    """Print the per-batch distances and their means; returns the losses
    {"kernel": [...], "plain": [...], "rows_plain": [...] or []}."""
    if not torch.cuda.is_available():
        raise RuntimeError("loss_drift runs on a CUDA device; "
                           "torch.cuda.is_available() is False")
    args = parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.models.convert import (params_from_flax,
                                              random_flax_params)
    from mst_tpu_torch.models.vit_fast import mst_logits
    from mst_tpu_torch.ops import fused_block as fb
    from mst_tpu_torch.train import cli
    from mst_tpu_torch.train.trainer import cross_entropy_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0] + "]"
    t0 = time.perf_counter()
    gargs = cli.parse_args(["--dataset", "Synthetic", "--model_size", "giant2",
                            "--freeze", "--batch_size", str(BATCH),
                            "--max_epochs", "1", "--num_train_samples",
                            str(BATCH), "--seed", str(args.seed)])
    model = cli.build_model(gargs)
    flat = random_flax_params(model, args.seed)
    rng = np.random.default_rng(args.seed + 7)
    for key in flat:
        if key.endswith("/gamma"):
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    params_from_flax(model, flat)
    model.eval()
    dm = cli.build_datamodule(gargs, dev, num_samples=args.batches * BATCH,
                              shape_cdhw=(1, 32, 224, 224))
    batches = [(b["source"], torch.from_numpy(b["target"]).to(dev, torch.long))
               for b in dm.val_dataloader()][:args.batches]
    print(f"{tag} {root.name}: giant2 drawn and {len(batches)} batches made "
          f"in {time.perf_counter() - t0:.1f} s")
    plain = {"fused_attention_sublayer": fb._attn_ref,
             "fused_swiglu_sublayer": fb._swiglu_ref}
    rows_plain = ({"ln_rows": lambda x, s, b, eps: fb._ln_rows_ref(x, s, b, eps)}
                  if hasattr(fb, "ln_rows") else None)

    def loss(src, tgt):
        with torch.no_grad():
            return cross_entropy_loss(mst_logits(model, src, None, train=True),
                                      tgt).item()

    res = {"kernel": [], "plain": [], "rows_plain": []}
    for src, tgt in batches:
        res["kernel"].append(loss(src, tgt))
        with routed(layers, plain):
            res["plain"].append(loss(src, tgt))
        if rows_plain is not None:
            with routed(fb, rows_plain):
                res["rows_plain"].append(loss(src, tgt))
    k, p = np.array(res["kernel"]), np.array(res["plain"])
    d = np.abs(k - p)
    print(f"{tag} {root.name}: |loss kernel - plain| per batch "
          f"{np.round(d, 5).tolist()}; mean {d.mean():.6g} (first 8 "
          f"{d[:8].mean():.6g}), largest {d.max():.6g}")
    if rows_plain is not None:
        r = np.array(res["rows_plain"])
        print(f"{tag} {root.name}: with ln_rows plain: |loss - plain| mean "
              f"{np.abs(r - p).mean():.6g}, |loss - kernel path| mean "
              f"{np.abs(r - k).mean():.6g}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
