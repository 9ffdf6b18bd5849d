"""Warm the decoded-volume disk cache (`--decode_cache` / `$MST_DECODE_CACHE`)
before training: decode every file of the given splits once through the
native thread pool, which writes each array through to the cache, then
check that every sample's entries exist (a failed decode is not an
error of the prefetch, so the check reads the cache directory), and print
the rate. Counterpart of `tools/warm_decode_cache.py`.

    python -m mst_tpu_torch.tools.warm_decode_cache --dataset LIDC \\
        --path_root /data/LIDC --decode_cache /fast/cache \\
        [--splits train,val,test] [--threads 16] [--chunk 32]

Exits 1, with a WARNING line per split, when a sample lacks an entry (the
first training epoch then decodes it).
"""

from __future__ import annotations

import argparse
import sys
import time

from mst_tpu_torch.registry import get_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mst_tpu_torch.tools.warm_decode_cache")
    ap.add_argument("--dataset", default="LIDC",
                    choices=["LIDC", "DUKE", "MRNet"])
    ap.add_argument("--path_root", required=True)
    ap.add_argument("--decode_cache", required=True)
    ap.add_argument("--splits", default="train,val,test")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None,
                    help="native decode pool size (default min(8, cores - "
                         "1); give the core count on a large host)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="samples per prefetch_decode call")
    args = ap.parse_args(argv)

    total = covered = 0
    t0 = time.perf_counter()
    for split in (s.strip() for s in args.splits.split(",")):
        try:
            ds = get_dataset(args.dataset, split=split,
                             path_root=args.path_root, fold=args.fold,
                             decode_cache=args.decode_cache)
        except FileNotFoundError as e:
            print(f"{split}: skipped ({e})", flush=True)
            continue
        n = len(ds)
        for lo in range(0, n, args.chunk):
            ds.prefetch_decode(list(range(lo, min(lo + args.chunk, n))),
                               num_threads=args.threads)
            # the arrays went to the disk cache; keep the memory bounded
            ds._decode_cache.clear()
            print(f"\r{split}: {min(lo + args.chunk, n)}/{n}", end="",
                  flush=True)
        print(flush=True)
        type(ds).flush_cache_writes()  # the check below reads the disk
        split_cov = 0
        for i in range(n):
            entries = [ds._cache_file(p) for p in ds.nifti_paths(i)]
            entries += [ds._cache_file(p, str(d)) for p, d in ds.h5_items(i)]
            if entries and all(e is not None and e.exists() for e in entries):
                split_cov += 1
        total += n
        covered += split_cov
        if split_cov < n:
            print(f"  WARNING {split}: only {split_cov}/{n} samples have "
                  f"complete cache entries; the rest decode in the first "
                  f"epoch (a file the native reader refused, or a failed "
                  f"write)", flush=True)
    dt = time.perf_counter() - t0
    print(f"warmed {total} samples, {covered} verified cached, in {dt:.1f}s "
          f"({total / max(dt, 1e-9):.1f} samples/s)", flush=True)
    return 0 if covered == total else 1


if __name__ == "__main__":
    sys.exit(main())
