"""Online inference serving: dynamic batching over the port's predict fn.

Counterpart of `mst_tpu/serve.py` (`BatchingPredictor`, `serve_http`) and
of `scripts/main_serve.py` (`main`), ported rather than imported because
importing `mst_tpu` pulls in JAX. Run as

    python -m mst_tpu_torch.serve [--init_seed 0 | --params_npz PATH |
        --run_folder RUN | --exported ART] [--batch_size 8] \
        [--max_wait_ms 5] [--host 127.0.0.1] [--port 8760] \
        [--dtype bfloat16] [--int8 [--int8_calib N [--path_root DIR]]]

It serves MST-DINOv2 ViT-S/14 (or the model of a `python -m
mst_tpu_torch.train` run folder, `load_run_model`: MST-DINOv3, a frozen
giant2 run, any slice fusion, the 3D ResNet and MST-ResNet too) on the
CUDA card. `--int8` serves the encoder on the W8A8
kernels (`ops/fused_int8.py`) with per-token activation scales;
`--int8_calib N` calibrates static ones on the first N volumes of the run
folder's val split (`calibration_volumes`: the run's fold, read under
`--path_root` unless the run is Synthetic) and folds them in. Slices of
any size divisible by the patch are served: up to 512 tokens on the fused
sub-layers, above (e.g. 518 px, 1370 tokens) on the composed path with the
flash kernels; an int8 model answers such a request with HTTP 400 (the
predictor's `ValueError`: int8 needs the fused path). `--exported ART`
serves an artifact of `python -m mst_tpu_torch.export` instead
(`export.load_exported`: the exported program replayed as one CUDA graph
per batch bucket, the weights of its params.npz; no model is built and
`mst_tpu_torch.models` is never imported); `--batch_size` must be one of
its buckets, and its dtype and int8 mode are the artifact's.

API:  POST /predict  (np.save bytes of a [C, D, H, W] float volume)
          -> {"probs": [...], "pred": argmax}
      GET  /healthz  -> {"ok": true, "model": ..., "volumes_served": N}

A collector thread drains up to `batch_size` queued volumes (waiting at
most `max_wait_ms` after the first), pads the tail batch by repeating the
first volume so every launch has one shape, and drops the padded rows.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("event", "result", "error", "abandoned")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False  # submitter timed out; don't burn device time


class BatchingPredictor:
    """Dynamic batching: blocking `submit(volume)` from any thread; a
    collector coalesces requests into one fixed-shape device batch.

    predict_fn: `train.predictor.make_predict_fn(...)` callable —
    (source [B, C, D, H, W], mask | None) -> (probs, None)."""

    def __init__(self, predict_fn, batch_size: int = 8,
                 max_wait_ms: float = 5.0):
        self._predict = predict_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()  # orders submits vs close()
        self.batches_run = 0
        self.volumes_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mst-serve-batcher")
        self._worker.start()

    def submit(self, volume: np.ndarray, timeout: Optional[float] = None
               ) -> np.ndarray:
        """volume [C, D, H, W] -> probs [n_classes] (blocks until served)."""
        if volume.ndim != 4:
            raise ValueError(f"expected a [C, D, H, W] volume, got shape "
                             f"{tuple(volume.shape)}")
        p = _Pending()
        # closed-check and enqueue under one lock: a submit racing close()
        # must not land behind the shutdown sentinel
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("predictor is closed")
            self._q.put((np.asarray(volume, np.float32), p))
        if not p.event.wait(timeout):
            p.abandoned = True  # the collector drops it instead of serving it
            raise TimeoutError("predict timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=10)

    def _collect(self):
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the sentinel for shutdown
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            batch = [b for b in batch if not b[1].abandoned]
            if not batch:
                continue
            vols = [b[0] for b in batch]
            pend = [b[1] for b in batch]
            try:
                n = len(vols)
                if n < self.batch_size:  # pad to the one batch shape
                    vols = vols + [vols[0]] * (self.batch_size - n)
                probs, _ = self._predict(np.stack(vols), None)
                if isinstance(probs, torch.Tensor):
                    probs = probs.float().cpu().numpy()
                probs = np.asarray(probs)
                self.batches_run += 1
                self.volumes_served += n
                for i, p in enumerate(pend):
                    p.result = probs[i]
                    p.event.set()
            except Exception as e:  # surface to every waiter, keep serving
                log.exception("batch of %d failed", len(pend))
                for p in pend:
                    p.error = e
                    p.event.set()


def serve_http(predictor: BatchingPredictor, host: str = "127.0.0.1",
               port: int = 8760, info: Optional[dict] = None
               ) -> ThreadingHTTPServer:
    """Start (and return) a threading HTTP server wrapping `predictor`.
    `port=0` binds an ephemeral port (`server.server_address[1]`). Stop it
    with `.shutdown()`, `.server_close()` and `predictor.close()`."""
    srv_info = dict(info or {})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            log.debug("http: " + fmt, *args)

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **srv_info,
                                 "volumes_served": predictor.volumes_served,
                                 "batches_run": predictor.batches_run})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                vol = np.load(io.BytesIO(self.rfile.read(length)),
                              allow_pickle=False)
            except Exception as e:  # malformed body -> caller's fault
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                probs = predictor.submit(vol)
                self._json(200, {"probs": [float(x) for x in probs],
                                 "pred": int(np.argmax(probs))})
            except ValueError as e:  # shape validation -> caller's fault
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # device / shutdown faults are ours: 5xx
                log.error("predict failed: %s: %s", type(e).__name__, e)
                self._json(503 if isinstance(e, (RuntimeError, TimeoutError))
                           else 500,
                           {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="mst-serve-http")
    thread.start()
    log.info("serving on http://%s:%d (batch %d)", host,
             server.server_address[1], predictor.batch_size)
    return server


_LATER = {
    "num_devices": "multi-GPU serving is ROADMAP queue A #13",
}


MODEL = "DinoV2ClassifierSlice"  # ViT-S/14, the flagship the port serves

# The model options a run folder's hparams may set (mst_tpu/serve.py's,
# and the port's `DinoSliceClassifier.config`).
_HPARAM_KEYS = (
    "model_size", "slice_fusion", "rotary", "use_bottleneck",
    "use_slice_pos_emb", "freeze", "fusion_heads", "num_register_tokens",
    "pos_embed_grid", "layerscale_init", "gelu_approximate", "use_rope_2d",
    "patch_size", "use_pos_embed", "rope_normalized", "norm_eps",
    "ffn_layer", "ffn_hidden", "fusion_layers", "rope_theta", "remat",
)


def load_run_model(run_folder, dtype=None):
    """Run folder (`python -m mst_tpu_torch.train` output) -> the model of
    its hparams with its best checkpoint's weights and, for a ResNet, its
    BatchNorm statistics (JAX's `load_run_model` returns them beside the
    params; the port's model holds them) (on the CPU, parameters f32;
    `dtype` is the compute dtype, default f32). The model name is the
    hparams' `model`, else the folder name's first part, as in the JAX
    package. A `linear` / `none` fusion head's slice count comes from the
    checkpoint's `head/kernel` rows."""
    from mst_tpu_torch.models.convert import params_from_flax
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.utils.checkpoint import (
        BEST_POINTER,
        load_best_batch_stats,
        load_best_params,
        load_hparams,
    )

    path_run = Path(run_folder)
    if not (path_run / BEST_POINTER).exists():
        raise FileNotFoundError(
            f"{path_run} is not a run folder (no {BEST_POINTER})")
    hparams = load_hparams(path_run) or {}
    name = hparams.get("model") or path_run.name.split("_")[0]
    model_kw = {k: v for k, v in hparams.items() if k in _HPARAM_KEYS}
    params = load_best_params(path_run)
    model = get_model(name, dtype=dtype or torch.float32, **model_kw)
    if getattr(model, "slice_fusion", None) in ("linear", "none"):
        model = get_model(name, dtype=dtype or torch.float32,
                          num_slices=params["head/kernel"].shape[0]
                          // model.emb_ch, **model_kw)
    return params_from_flax(model, params, load_best_batch_stats(path_run))


def load_weights(model, args):
    """Load --params_npz (a flat '/'-keyed .npz of the flax parameter tree)
    or seeded random weights (--init_seed) into `model`; returns it."""
    from mst_tpu_torch.models.convert import params_from_flax, random_flax_params

    if args.params_npz:
        with np.load(args.params_npz, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = random_flax_params(model, args.init_seed)
    return params_from_flax(model, flat)


def calibration_volumes(run_folder, n: int, path_root=None,
                        **dataset_kw) -> np.ndarray:
    """The first `n` val-split volumes of the run's own dataset (its
    hparams' `dataset`, else the run folder's parent name) as [n, C, D, H,
    W] f32: the static-int8 calibration contract of `mst_tpu/serve.py`
    (`calibration_volumes`). A dataset read from files takes `path_root`
    and the run's `fold`; without a root it raises JAX's ValueError, which
    the CLIs turn into their usage error. `dataset_kw` go to the dataset
    (e.g. `shape_cdhw` of Synthetic)."""
    from mst_tpu_torch.registry import get_dataset
    from mst_tpu_torch.utils.checkpoint import load_hparams

    run = Path(run_folder)
    hparams = load_hparams(run) or {}
    name = hparams.get("dataset") or run.parent.name
    if name != "Synthetic":
        if not path_root:
            raise ValueError(
                "static int8 calibration draws volumes from the run's val "
                "split — pass --path_root (or use dynamic scales: --int8 "
                "without --int8_calib)")
        dataset_kw = dict(dataset_kw, path_root=path_root,
                          fold=hparams.get("fold", 0))
    ds = get_dataset(name, split="val", **dataset_kw)
    return np.stack([np.asarray(ds[i]["source"], np.float32)
                     for i in range(min(int(n), len(ds)))])


def int8_calibration(args, **dataset_kw):
    """The calibration volumes of --int8_calib N (None without it) from
    the --run_folder's val split under --path_root; a missing root is a
    usage error, as `scripts/main_serve.py` makes it."""
    if not args.int8_calib:
        return None
    try:
        return calibration_volumes(args.run_folder, args.int8_calib,
                                   args.path_root, **dataset_kw)
    except ValueError as e:
        raise SystemExit(f"--int8_calib: {e}")


def build_model(args, device="cuda", **dataset_kw):
    """-> the --run_folder's model, or MODEL with --params_npz / seeded
    weights, on the CUDA card (or `device`) in --dtype; with --int8 its
    W8A8 copy (`quantize_mst_int8`), per-token activation scales, or with
    --int8_calib N static ones calibrated on `calibration_volumes` of the
    run's val split under --path_root (`dataset_kw` go to its dataset)."""
    from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
    from mst_tpu_torch.registry import get_model

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.run_folder:
        model = load_run_model(args.run_folder, dtype)
    else:
        model = load_weights(get_model(MODEL, dtype=dtype), args)
    model = model.to(torch.device(device)).eval()
    if not args.int8:
        return model
    return quantize_mst_int8(model, int8_calibration(args, **dataset_kw))


def build_server(args, model):
    """-> (server, predictor) serving `model`; split from main() for
    in-process use."""
    from mst_tpu_torch.train.predictor import make_predict_fn

    predictor = BatchingPredictor(make_predict_fn(model, with_saliency=False),
                                  batch_size=args.batch_size,
                                  max_wait_ms=args.max_wait_ms)
    device = next(model.parameters()).device
    name = MODEL
    if args.run_folder:
        from mst_tpu_torch.utils.checkpoint import load_hparams

        name = (load_hparams(args.run_folder) or {}).get("model", name)
    server = serve_http(predictor, host=args.host, port=args.port,
                        info={"model": name, "device": str(device),
                              "batch_size": args.batch_size,
                              "dtype": args.dtype,
                              "int8": ("static" if args.int8_calib else
                                       "dynamic") if args.int8 else None})
    return server, predictor


def build_exported_server(args, exported):
    """-> (server, predictor) serving the loaded artifact `exported`
    (`export.load_exported`), as `scripts/main_serve.py`'s artifact branch:
    the batch size must be an exported bucket."""
    if args.batch_size not in exported.buckets:
        raise SystemExit(
            f"--batch_size {args.batch_size} is not an exported bucket "
            f"{exported.buckets}; pick one or re-export with it included")
    predictor = BatchingPredictor(exported, batch_size=args.batch_size,
                                  max_wait_ms=args.max_wait_ms)
    meta = exported.meta
    server = serve_http(predictor, host=args.host, port=args.port,
                        info={"model": meta.get("model"),
                              "device": str(exported.device),
                              "batch_size": args.batch_size,
                              "dtype": meta.get("dtype"),
                              "exported": str(args.exported),
                              "int8": ("static" if meta.get("int8_static")
                                       else "dynamic") if meta.get("int8")
                              else None})
    return server, predictor


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.serve")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--run_folder", default=None,
                     help="a `python -m mst_tpu_torch.train` run folder: "
                          "its model and best checkpoint")
    src.add_argument("--params_npz", default=None,
                     help="flat '/'-keyed .npz of the flax parameter tree")
    src.add_argument("--init_seed", type=int, default=0,
                     help="seeded random weights (default when none)")
    src.add_argument("--exported", default=None,
                     help="a `python -m mst_tpu_torch.export` artifact: "
                          "its programs and weights, no model code")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8760)
    ap.add_argument("--batch_size", type=int, default=8,
                    help="device batch: requests coalesce up to this many "
                         "per launch (tails padded)")
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="max time the batcher waits for co-riders after "
                         "the first queued request")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--int8", action="store_true",
                    help="serve the encoder on the W8A8 int8 kernels "
                         "(per-token activation scales)")
    ap.add_argument("--int8_calib", type=int, default=0, metavar="N",
                    help="with --int8 and --run_folder: calibrate static "
                         "activation scales on the first N volumes of the "
                         "run's val split and fold them in (0: per-token "
                         "scales)")
    ap.add_argument("--path_root", default=None,
                    help="the run's dataset folder: only needed for "
                         "--int8_calib (calibration volumes come from the "
                         "val split)")
    ap.add_argument("--num_devices", type=int, default=1)
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        val = getattr(args, flag)
        if val and not (flag == "num_devices" and val == 1):
            ap.error(f"--{flag}: not ported to mst_tpu_torch yet ({why})")
    if args.exported and args.int8:
        ap.error("--int8 with --exported: the artifact's int8 mode is set "
                 "when it is exported (python -m mst_tpu_torch.export "
                 "--int8)")
    if args.int8_calib and not (args.int8 and args.run_folder):
        ap.error("--int8_calib N needs --int8 and --run_folder (static "
                 "scales are calibrated on the run's val split)")
    return args


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    if args.exported:
        from mst_tpu_torch.export import load_exported

        server, predictor = build_exported_server(
            args, load_exported(args.exported))
    else:
        server, predictor = build_server(args, build_model(args))
    log.info("ready — POST /predict, GET /healthz; Ctrl-C to stop")
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()


if __name__ == "__main__":
    main()
