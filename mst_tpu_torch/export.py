"""Serving artifacts: the port's predict program exported per batch bucket.

Counterpart of `mst_tpu/export.py` (`save_exported`, `load_exported`,
`ExportedPredictor`) and of `scripts/main_export.py` (`main`), ported
rather than imported because importing `mst_tpu` pulls in JAX. Run as

    python -m mst_tpu_torch.export --run_folder RUN --out ART \\
        [--batch_sizes 1,4,8] [--int8 [--int8_calib N]] \\
        [--with_saliency [--plane_mode rollout]] [--use_tta] [--with_mask] \\
        [--depth 32] [--hw 224] [--dtype bfloat16] [--path_root DIR]

and serve the result with `python -m mst_tpu_torch.serve --exported ART`.

`save_exported` traces the predict program (`train.predictor.
predict_program`: the fused kernel path, int8 or bf16, the composed path
with the flash kernels above 512 tokens, the saliency and TTA forms, a
ResNet's own forward) with `torch.export`, once per batch bucket. While it
traces, the kernel wrappers call their registered ops (`torch.ops.
mst_tpu_torch.*`, `ops/attention.exporting`), so each hand-written kernel
is one node of the graph, and the loaded program launches the same kernels
in the same order as the live model. Every parameter and buffer of the
model is an input of the program (`torch.func.functional_call`), so the
program holds no weights: it takes (params, source[, mask]), as the JAX
program does, and can be re-pointed at another tree of the same structure.

Artifact layout (a directory):
    meta.json          buckets, shapes, the model and its options, the
                       program's inputs (key, dtype, shape), the torch and
                       CUDA versions, the device type and the card's name
    program_b{N}.pt2   `torch.export.save` of the program at bucket N
    params.npz         the flat '/'-keyed flax tree (bf16 as uint16 views)
    batch_stats.npz    a ResNet's BatchNorm statistics, flax keys

`load_exported` needs no model code: it imports the kernel ops (to
register them) and nothing of `mst_tpu_torch.models`. On the card each
bucket is loaded at its first use, the weights are uploaded once, and the
call is captured in a CUDA graph with static input buffers; later calls
copy into those buffers and replay the graph (the counterpart of JAX's
jit once per bucket). A failed capture or a missing kernel library
raises: nothing falls back to the uncaptured call or the plain path.

Not ported (ROADMAP "Not to port"): `--platforms` cross-lowering and the
`compiled_b{N}.bin` executable leg (a loaded program needs no compile; the
kernels are built once into `build/mst_tpu_torch/`), `--compilation_cache`.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["save_exported", "load_exported", "ExportedPredictor", "main"]

log = logging.getLogger(__name__)

_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"
_STATS_NAME = "batch_stats.npz"
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# params <-> npz (bf16 stored as same-width uint views, as the JAX package)


_UINT_VIEW = {torch.bfloat16: (torch.int16, np.uint16)}


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict of arrays -> the flat '/'-keyed dict (flat stays)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _save_params_npz(path: Path, params) -> dict:
    """Write a (flat or nested) tree of numpy arrays or tensors; returns
    {key: dtype name} for the leaves stored as uint views (bf16)."""
    dtypes, arrays = {}, {}
    for k, v in _flat(params).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype in _UINT_VIEW:
                dtypes[k] = str(v.dtype).removeprefix("torch.")
                signed, unsigned = _UINT_VIEW[v.dtype]
                v = v.view(signed).numpy().view(unsigned)
            else:
                v = v.numpy()
        arrays[k] = np.asarray(v)
    np.savez(path, **arrays)
    return dtypes


def _load_params_npz(path: Path, dtypes: dict) -> dict:
    """-> the flat '/'-keyed dict of CPU tensors, the uint views of `dtypes`
    viewed back as their dtype (bf16 without ml_dtypes)."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            t = torch.from_numpy(np.array(z[k]))
            if k in dtypes:
                t = t.view(getattr(torch, dtypes[k]))
            out[k] = t
    return out


# ---------------------------------------------------------------------------
# export


def _card_name() -> Optional[str]:
    """The card's name as `nvidia-smi` gives it, or None without one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _program_tree(model):
    """(params, batch_stats, inputs, derived) of `model`: the flat flax
    tree (parameters and the persistent buffers of int8 `QDense` nodes),
    the ResNets' BatchNorm statistics, every tensor the program takes by
    flax-style key, and the K-major `q8t` copies by the `q8` they copy."""
    from mst_tpu_torch.models.convert import _stat_buffers

    stats = {k.replace(".", "/") for k in _stat_buffers(model)}
    persistent = dict(model.state_dict(keep_vars=True))
    inputs = {k.replace(".", "/"): t.detach() for k, t in (
        *model.named_parameters(), *model.named_buffers())}
    derived = {k: k[:-len("q8t")] + "q8" for k in inputs
               if k.endswith("/q8t")}
    params = {k: t for k, t in inputs.items()
              if k not in stats and k.replace("/", ".") in persistent}
    batch_stats = {k: inputs[k] for k in sorted(stats)}
    return params, batch_stats, inputs, derived


class _Bound(torch.nn.Module):
    """The predict program over `model` (a registered submodule, so that
    `functional_call` can swap every tensor of it)."""

    def __init__(self, model, body):
        super().__init__()
        self.model = model
        self._body = body

    def forward(self, source, mask=None):
        return self._body(source, mask)


class _Program(torch.nn.Module):
    """forward(params {key: tensor}, source[, mask]) -> (probs, saliency):
    the bound program with every tensor of the model taken from `params`.
    It registers no parameter, so the exported program holds none."""

    def __init__(self, bound, with_mask: bool):
        super().__init__()
        self.__dict__["bound"] = bound  # not a submodule: no state here
        self.with_mask = with_mask

    def forward(self, params, source, mask=None):
        tensors = {"model." + k.replace("/", "."): v
                   for k, v in params.items()}
        args = (source, mask if self.with_mask else None)
        return torch.func.functional_call(self.bound, tensors, args,
                                          strict=True)


def _int8_mode(model) -> Optional[str]:
    """"static" / "dynamic" for an int8 (`QDense`) encoder, else None."""
    from mst_tpu_torch.models.layers import QDense

    qdense = [m for m in model.modules() if isinstance(m, QDense)]
    if not qdense:
        return None
    return ("static" if any(m.a_inv is not None for m in qdense)
            else "dynamic")


def save_exported(out_dir, model, *, batch_sizes: Sequence[int],
                  depth: int = 32, hw: int = 224, with_saliency: bool = False,
                  plane_mode: str = "last", tta: bool = False,
                  with_mask: bool = False, in_ch: int = 1,
                  extra_meta: Optional[dict] = None) -> Path:
    """Export `model`'s predict program at each batch bucket, on the
    model's device, with its weights (and a ResNet's BatchNorm statistics)
    beside it. `model` may be int8-quantized (`quantize_mst_int8`): the
    program then IS the W8A8 serving program. `with_mask` exports programs
    that take a [B, D] src_key_padding_mask (True = padded slice); without
    it the mask is traced as None."""
    from mst_tpu_torch.ops import fused_int8  # noqa: F401 (registers ops)
    from mst_tpu_torch.train.predictor import predict_program

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model = model.eval()
    device = next(model.parameters()).device
    params, batch_stats, inputs, derived = _program_tree(model)
    program = _Program(_Bound(model, predict_program(
        model, tta=tta, with_saliency=with_saliency, plane_mode=plane_mode)),
        with_mask)
    buckets = sorted({int(b) for b in batch_sizes})
    for b in buckets:
        args = [inputs, torch.zeros((b, in_ch, depth, hw, hw),
                                    device=device)]
        if with_mask:
            args.append(torch.zeros((b, depth), dtype=torch.bool,
                                    device=device))
        with torch.no_grad():
            ep = torch.export.export(program, tuple(args))
        ep.example_inputs = None  # they would put the weights in the file
        torch.export.save(ep, out / f"program_b{b}.pt2")

    dtypes = _save_params_npz(out / _PARAMS_NAME, params)
    if batch_stats:
        _save_params_npz(out / _STATS_NAME, batch_stats)
    int8 = _int8_mode(model)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": type(model).__name__,
        "batch_sizes": buckets,
        "depth": depth, "hw": hw, "in_ch": in_ch,
        "with_saliency": bool(with_saliency),
        "plane_mode": plane_mode,
        "tta": bool(tta),
        "with_mask": bool(with_mask),
        "int8": int8 is not None,
        "int8_static": int8 == "static",
        "dtype": str(getattr(model, "dtype", torch.float32)
                     ).removeprefix("torch."),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_type": device.type,
        "device_name": _card_name() if device.type == "cuda" else None,
        "param_dtypes": dtypes,
        # the program's inputs in its order: key, dtype, shape
        "inputs": [[k, str(t.dtype).removeprefix("torch."), list(t.shape)]
                   for k, t in inputs.items()],
        "derived": derived,
        **(extra_meta or {}),
    }
    (out / _META_NAME).write_text(json.dumps(meta, indent=1))
    return out


# ---------------------------------------------------------------------------
# load


def _constants_on(gm, device):
    """The loaded program `gm` with its traced constants (the pos-embed
    resampling weights, the RoPE tables) moved to `device` once. They load
    on the host, and the graph would copy them to the device on every call,
    which a CUDA graph cannot capture from pageable memory; the graph's
    checks that they lie on the host (`_assert_tensor_metadata`, checks
    only) go with the move."""
    for node in list(gm.graph.nodes):
        if node.op == "get_attr":
            owner, _, name = node.target.rpartition(".")
            mod = gm.get_submodule(owner) if owner else gm
            t = getattr(mod, name)
            if isinstance(t, torch.Tensor) and t.device != device:
                setattr(mod, name, t.to(device))
        elif node.target is torch.ops.aten._assert_tensor_metadata.default:
            gm.graph.erase_node(node)
    gm.recompile()
    return gm


class ExportedPredictor:
    """A loaded serving artifact: `predict(volumes) -> (probs, saliency)`,
    numpy f32.

    Dispatches each call to the smallest exported batch bucket that fits,
    padding the tail by repeating row 0 (row results do not depend on the
    other rows) and slicing it back off. On CUDA, with `cuda_graphs`, each
    bucket's program is captured in a CUDA graph at its first use and
    replayed after; without, the loaded program is called as it is."""

    def __init__(self, meta: dict, params: dict, batch_stats: dict,
                 path: Path, device: torch.device, cuda_graphs: bool = True):
        self.meta = meta
        self.params = params
        self.batch_stats = batch_stats
        self.buckets = sorted(int(b) for b in meta["batch_sizes"])
        self.device = device
        self.path = Path(path)
        self.cuda_graphs = cuda_graphs and device.type == "cuda"
        self._programs: dict = {}  # bucket -> the loaded program's module
        self._graphs: dict = {}  # bucket -> (graph, source, mask, outputs)
        self._inputs: Optional[dict] = None  # key -> tensor on the device
        self._inputs_src = None

    def _program(self, b: int):
        if b not in self._programs:
            ep = torch.export.load(self.path / f"program_b{b}.pt2")
            self._programs[b] = _constants_on(ep.module(), self.device)
        return self._programs[b]

    def program_inputs(self, params=None) -> dict:
        """The program's inputs from the flat (or nested) tree `params`
        (default: the artifact's) and the artifact's BatchNorm statistics,
        on the device, each in the dtype and shape it was exported with;
        every `q8t` rebuilt from its `q8`. A new tree is copied into the
        tensors a captured graph reads, so the graphs stay valid."""
        params = self.params if params is None else params
        if params is self._inputs_src and self._inputs is not None:
            return self._inputs
        flat = {**self.batch_stats, **_flat(params)}
        derived = self.meta.get("derived", {})
        new = {}
        for key, dtype, shape in self.meta["inputs"]:
            src = derived.get(key)
            if src is not None:
                t = torch.as_tensor(flat[src]).t().contiguous()
            elif key in flat:
                t = torch.as_tensor(flat[key])
            else:
                raise KeyError(f"params has no {key!r}, an input of the "
                               f"exported program")
            if list(t.shape) != shape:
                raise ValueError(f"{key}: shape {list(t.shape)}, the program "
                                 f"takes {shape}")
            # a copy: a later tree is copied into these tensors
            new[key] = t.to(self.device, getattr(torch, dtype), copy=True)
        if self._inputs is None:
            self._inputs = new
        else:
            with torch.no_grad():
                for key, t in new.items():
                    self._inputs[key].copy_(t)
        self._inputs_src = params
        return self._inputs

    def _call(self, b: int, inputs: dict, source, mask):
        args = (inputs, source, mask) if mask is not None else (
            inputs, source)
        with torch.no_grad():
            return self._program(b)(*args)

    def _replay(self, b: int, inputs: dict, source, mask):
        """The bucket's CUDA graph (captured at its first call, after one
        warm-up call on a side stream) replayed on `source` / `mask`."""
        if b not in self._graphs:
            src = torch.zeros_like(source)
            msk = None if mask is None else torch.zeros_like(mask)
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self._call(b, inputs, src, msk)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._call(b, inputs, src, msk)
            self._graphs[b] = (graph, src, msk, outs)
        graph, src, msk, outs = self._graphs[b]
        src.copy_(source)
        if msk is not None:
            msk.copy_(mask)
        graph.replay()
        return outs

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch {n} exceeds the largest exported bucket "
            f"{self.buckets[-1]}; re-export with a larger --batch_sizes")

    def predict(self, source, params=None, mask=None):
        """source [B, C, D, H, W] (+ optional src_key_padding_mask [B, D]),
        numpy or tensors -> (probs [B, n] f32, saliency [B, D, H, W] f32 |
        None), numpy. `params`: another tree of the same structure (flat
        '/'-keyed or nested), uploaded once and kept until the next one."""
        with_mask = bool(self.meta.get("with_mask"))
        if mask is not None and not with_mask:
            raise ValueError("this artifact was exported without mask "
                             "support (mask traced as None); re-export "
                             "with with_mask=True / --with_mask")
        src = torch.as_tensor(source).to(self.device, torch.float32)
        n = src.shape[0]
        b = self.bucket_for(n)
        msk = None
        if with_mask:
            # absent mask == nothing padded (all-False == None semantics)
            msk = (torch.zeros((n, src.shape[2]), dtype=torch.bool,
                               device=self.device) if mask is None else
                   torch.as_tensor(mask).to(self.device, torch.bool))
        if n < b:  # pad by repeating row 0, sliced off below
            src = torch.cat([src, src[:1].expand(b - n, *src.shape[1:])])
            if msk is not None:
                msk = torch.cat([msk, msk[:1].expand(b - n, msk.shape[1])])
        inputs = self.program_inputs(params)
        run = self._replay if self.cuda_graphs else self._call
        probs, sal = run(b, inputs, src, msk)
        probs = probs[:n].float().cpu().numpy()
        if sal is not None:
            sal = sal[:n].float().cpu().numpy()
        return probs, sal

    # BatchingPredictor's call (mst_tpu_torch/serve.py): full buckets, so
    # no padding happens here.
    def __call__(self, source, mask=None):
        return self.predict(source, mask=mask)


def load_exported(artifact_dir, device=None,
                  cuda_graphs: bool = True) -> ExportedPredictor:
    """Load a serving artifact onto the card (or `device`; "cpu" only when
    asked). An artifact exported for another device type raises; programs
    load at their bucket's first use."""
    from mst_tpu_torch.ops import fused_int8  # noqa: F401 (registers ops)

    path = Path(artifact_dir)
    meta = json.loads((path / _META_NAME).read_text())
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_exported: no CUDA device (pass "
                           "device='cpu' for a CPU artifact)")
    if meta.get("device_type") != device.type:
        raise ValueError(f"{path} was exported for {meta.get('device_type')}"
                         f", not {device.type}: re-export it there")
    params = _load_params_npz(path / _PARAMS_NAME,
                              meta.get("param_dtypes", {}))
    stats = (_load_params_npz(path / _STATS_NAME, {})
             if (path / _STATS_NAME).exists() else {})
    return ExportedPredictor(meta, params, stats, path, device, cuda_graphs)


# ---------------------------------------------------------------------------
# CLI (scripts/main_export.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mst_tpu_torch.export")
    ap.add_argument("--run_folder", required=True)
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--batch_sizes", default="1,4,8",
                    help="comma-separated batch buckets to export")
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--int8", action="store_true",
                    help="export the W8A8 int8 serving program")
    ap.add_argument("--int8_calib", type=int, default=0, metavar="N",
                    help="with --int8: calibrate static activation scales "
                         "on the first N volumes of the run's val split")
    ap.add_argument("--path_root", default=None,
                    help="the run's dataset folder, for --int8_calib")
    ap.add_argument("--with_saliency", action="store_true",
                    help="export the saliency-emitting program")
    ap.add_argument("--plane_mode", default="last",
                    choices=["last", "rollout", "rollout_abnar"])
    ap.add_argument("--use_tta", action="store_true",
                    help="export the 8-flip TTA ensemble program")
    ap.add_argument("--with_mask", action="store_true",
                    help="export programs taking a [B, D] "
                         "src_key_padding_mask (MRNet's variable-depth "
                         "volumes); default traces the mask as None")
    args = ap.parse_args(argv)
    if args.int8_calib and not args.int8:
        ap.error("--int8_calib N needs --int8")
    return args


def main(argv=None, device="cuda", **dataset_kw) -> Path:
    """Export a `python -m mst_tpu_torch.train` run folder's model on the
    card (or `device`); `dataset_kw` go to the calibration dataset."""
    from mst_tpu_torch.models.vit_fast import int8_config_supported
    from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
    from mst_tpu_torch.serve import build_model, int8_calibration

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    serve_args = argparse.Namespace(
        run_folder=args.run_folder, params_npz=None, init_seed=0,
        dtype=args.dtype, int8=False, int8_calib=0)
    model = build_model(serve_args, device)
    if args.int8:
        if not int8_config_supported(model):
            raise SystemExit("--int8 needs the fused serving path (a "
                             "DinoSliceClassifier with the transformer "
                             "fusion and no rotary)")
        model = quantize_mst_int8(model, int8_calibration(args,
                                                          **dataset_kw))
    out = save_exported(
        args.out, model, batch_sizes=[int(b) for b in
                                      args.batch_sizes.split(",")],
        depth=args.depth, hw=args.hw, with_saliency=args.with_saliency,
        plane_mode=args.plane_mode, tta=args.use_tta,
        with_mask=args.with_mask,
        extra_meta={"run_folder": str(args.run_folder)})
    total = sum(f.stat().st_size for f in out.iterdir())
    log.info("exported %s (buckets %s, %.1f MB) -> %s",
             type(model).__name__, args.batch_sizes, total / 1e6, out)
    return out


if __name__ == "__main__":
    main()
