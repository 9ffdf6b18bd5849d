"""The port's serving artifacts (`mst_tpu_torch/export.py`, `python -m
mst_tpu_torch.export`, `serve --exported`) against the live port and
against `mst_tpu.export` on the same seeded weights, at the tiny sizes of
`tests/test_export.py`.

On the CPU the exported graph calls the registered ops
(`torch.ops.mst_tpu_torch.*`), whose CPU implementations are the kernels'
plain versions: a loaded program gives the live port's rows to 1e-6 (here
bit for bit), and the JAX artifact's (Pallas in interpret mode) to 1e-4,
the saliency maps to 1e-4 of their largest value."""

import io
import json
import shutil
import subprocess
import sys
import urllib.request
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from mst_tpu.export import _load_params_npz as jax_load_params_npz
from mst_tpu.export import _save_params_npz as jax_save_params_npz
from mst_tpu.export import load_exported as jax_load_exported
from mst_tpu.export import save_exported as jax_save_exported
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.models.resnet import ResNet3DClassifier as JaxResNet3D
from mst_tpu.models.resnet import ResNetSliceTrans as JaxResNetSliceTrans
from mst_tpu.ops.fused_int8 import quantize_mst_params_int8
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu_torch import export as ex
from mst_tpu_torch import serve
from mst_tpu_torch.models.convert import (
    initial_batch_stats,
    params_from_flax,
    random_flax_params,
)
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.resnet import ResNet3DClassifier, ResNetSliceTrans
from mst_tpu_torch.ops import attention as tat
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops import fused_int8 as tfq
from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
JAX_TOL = 1e-4  # probs, and maps relative to their largest value
LIVE_TOL = 1e-6
MODES = ("last", "rollout", "rollout_abnar")


def _flat(seed, model):
    """Seeded flat flax params of `model` with O(1) LayerScale."""
    flat = random_flax_params(model, seed)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    return flat


def _pair(seed=0, size="tiny"):
    """(port model, JAX model, JAX params) of the same seeded weights."""
    kw = dict(TINY, model_size=size)
    tm = DinoSliceClassifier(out_ch=2, **kw)
    flat = _flat(seed, tm)
    params_from_flax(tm, flat)
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})
    return tm.eval(), JaxMST(out_ch=2, use_flash=False, **kw), jparams


def _vols(n, seed=7, hw=28, depth=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, depth, hw, hw)).astype(np.float32)


def _graph_ops(art, b):
    ep = torch.export.load(Path(art) / f"program_b{b}.pt2")
    ops = {}
    for node in ep.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("mst_tpu_torch."):
            ops[target.split(".")[1]] = ops.get(target.split(".")[1], 0) + 1
    return ops


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The port's and the JAX package's artifacts of one seeded tiny model,
    buckets [2, 4]."""
    base = tmp_path_factory.mktemp("export")
    tm, jm, jparams = _pair()
    art = ex.save_exported(base / "port", tm, batch_sizes=[4, 2], depth=2,
                           hw=28)
    jart = jax_save_exported(base / "jax", jm, jparams, batch_sizes=[2, 4],
                             depth=2, hw=28)
    return tm, art, jart


def test_export_roundtrip_buckets_and_padding(shared, tmp_path):
    tm, art, jart = shared
    meta = json.loads((art / "meta.json").read_text())
    assert meta["batch_sizes"] == [2, 4] and meta["device_type"] == "cpu"
    assert meta["model"] == "DinoSliceClassifier" and not meta["int8"]
    assert {"torch_version", "cuda_version", "device_name"} <= set(meta)
    # each fused sub-layer's kernels are nodes of the graph
    assert _graph_ops(art, 2) == {"ln_rows": 2, "gemm_act": 2, "mhsa": 1,
                                  "gemm_residual": 2}
    loaded = ex.load_exported(art, device="cpu")
    vols = _vols(3)
    ref = make_predict_fn(tm, with_saliency=False)(vols)[0].numpy()
    jref, _ = jax_load_exported(jart).predict(vols)
    # batch 3 -> bucket 4 (padded); batch 2 -> exact bucket
    probs, sal = loaded.predict(vols)
    assert sal is None and probs.shape == (3, 2)
    np.testing.assert_allclose(probs, ref, atol=LIVE_TOL)
    np.testing.assert_allclose(probs, jref, atol=JAX_TOL)
    probs2, _ = loaded.predict(torch.from_numpy(vols[:2]))
    np.testing.assert_allclose(probs2, ref[:2], atol=LIVE_TOL)
    # BatchingPredictor's call (full buckets)
    np.testing.assert_allclose(loaded(vols[:2], None)[0], ref[:2],
                               atol=LIVE_TOL)
    with pytest.raises(ValueError, match="largest exported bucket"):
        loaded.predict(np.repeat(vols, 2, axis=0))
    with pytest.raises(ValueError, match="without mask"):
        loaded(vols[:2], np.zeros((2, 2), bool))
    # an artifact of another device type is refused, and the default device
    # is the card
    other = tmp_path / "cuda_art"
    shutil.copytree(art, other)
    meta["device_type"] = "cuda"
    (other / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        ex.load_exported(other, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.load_exported(art)


@pytest.mark.parametrize("mode,tta", [("last", False), ("rollout", True),
                                      ("rollout_abnar", False)])
def test_export_saliency_programs(mode, tta, tmp_path):
    tm, jm, jparams = _pair(3)
    kw = dict(batch_sizes=[2], depth=2, hw=28, with_saliency=True,
              plane_mode=mode, tta=tta)
    art = ex.save_exported(tmp_path / "port", tm, **kw)
    jart = jax_save_exported(tmp_path / "jax", jm, jparams, **kw)
    vols = _vols(2, seed=9)
    probs, sal = ex.load_exported(art, device="cpu").predict(vols)
    ref_p, ref_s = make_predict_fn(tm, tta=tta, plane_mode=mode)(vols)
    np.testing.assert_allclose(probs, ref_p.numpy(), atol=LIVE_TOL)
    np.testing.assert_allclose(sal, ref_s.numpy(), atol=LIVE_TOL)
    jp, js = jax_load_exported(jart).predict(vols)
    assert sal.shape == js.shape == (2, 2, 28, 28)
    np.testing.assert_allclose(probs, jp, atol=JAX_TOL)
    np.testing.assert_allclose(sal, js, atol=JAX_TOL * np.abs(js).max())
    # the saliency forms of `mhsa` are nodes too: all blocks in the
    # rollout modes, the last one's CLS row in the cheap `last` path
    ops = _graph_ops(art, 2)
    assert ops["mhsa"] == (1 if mode == "last" else 2)


@pytest.mark.parametrize("mode", MODES)
def test_export_long_saliency_programs(mode, tmp_path):
    """Saliency of 322 px slices (S = 530, above FUSED_MAX_TOKENS): the
    composed path's program, its flash forward with the LSE and each
    block's saliency kernel nodes of the graph (`rollout_abnar`: each
    block's row normaliser and one carry a block for the sweep back), as
    many as the live forward launches on the card; its rows the live
    port's (1e-6) and the JAX artifact's (1e-4, maps relative to their
    largest value)."""
    tm, jm, jparams = _pair(13)
    kw = dict(batch_sizes=[2], depth=2, hw=322, with_saliency=True,
              plane_mode=mode)
    art = ex.save_exported(tmp_path / "port", tm, **kw)
    jart = jax_save_exported(tmp_path / "jax", jm, jparams, **kw)
    vols = _vols(2, seed=14, hw=322)
    probs, sal = ex.load_exported(art, device="cpu").predict(vols)
    ref_p, ref_s = make_predict_fn(tm, plane_mode=mode)(vols)
    np.testing.assert_allclose(probs, ref_p.numpy(), atol=LIVE_TOL)
    np.testing.assert_allclose(sal, ref_s.numpy(),
                               atol=LIVE_TOL * np.abs(sal).max())
    jp, js = jax_load_exported(jart).predict(vols)
    assert sal.shape == js.shape == (2, 2, 322, 322)
    np.testing.assert_allclose(probs, jp, atol=JAX_TOL)
    np.testing.assert_allclose(sal, js, atol=JAX_TOL * np.abs(js).max())
    depth = tm.encoder.depth
    out = {"last": "flash_row", "rollout": "flash_carry",
           "rollout_abnar": "flash_abnar"}[mode]
    n_sal = 1 if mode == "last" else depth
    want = {"flash_fwd_lse": n_sal, out: n_sal}
    if mode == "rollout_abnar":
        want["flash_carry"] = depth
    if depth > n_sal:
        want["flash_fwd"] = depth - n_sal
    assert _graph_ops(art, 2) == want


def test_export_with_mask(tmp_path):
    tm, jm, jparams = _pair(5)
    kw = dict(batch_sizes=[2], depth=2, hw=28, with_mask=True)
    art = ex.save_exported(tmp_path / "port", tm, **kw)
    jart = jax_save_exported(tmp_path / "jax", jm, jparams, **kw)
    loaded = ex.load_exported(art, device="cpu")
    assert loaded.meta["with_mask"] is True
    vols = _vols(2, seed=11)
    mask = np.array([[False, True], [False, False]])  # pad slice 1 of vol 0
    live = make_predict_fn(tm, with_saliency=False)
    probs_m, _ = loaded.predict(vols, mask=mask)
    probs_0, _ = loaded.predict(vols)  # no mask -> all-False == None
    np.testing.assert_allclose(probs_m, live(vols, mask)[0].numpy(),
                               atol=LIVE_TOL)
    np.testing.assert_allclose(probs_0, live(vols)[0].numpy(), atol=LIVE_TOL)
    np.testing.assert_allclose(probs_m, jax_load_exported(jart).predict(
        vols, mask=mask)[0], atol=JAX_TOL)
    assert np.abs(probs_m - probs_0).max() > 1e-6  # the masked row moved
    np.testing.assert_allclose(probs_m[1], probs_0[1], atol=LIVE_TOL)
    np.testing.assert_allclose(loaded(vols, mask)[0], probs_m, atol=0)


def _tree(flat):
    """A flat '/'-keyed dict of arrays -> the nested flax tree."""
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _resnet(cls, seed, **kw):
    model = cls(out_ch=2, variant=18, **kw)
    rng = np.random.default_rng(seed)
    stats = {k: (v + 0.1 * rng.standard_normal(v.shape) if k.endswith(
        "/mean") else v * (1.0 + 0.5 * np.abs(rng.standard_normal(v.shape)))
                 ).astype(np.float32)
             for k, v in initial_batch_stats(model).items()}
    flat = random_flax_params(model, seed)
    return params_from_flax(model, flat, stats).eval(), flat, stats


def test_export_resnet_batch_stats(tmp_path):
    """MST-ResNet18 with its BatchNorm statistics (beside the weights, in
    batch_stats.npz), against the live port and the JAX artifact (which
    bakes them into its program)."""
    tm, flat, stats = _resnet(ResNetSliceTrans, 0, fusion_heads=8)
    art = ex.save_exported(tmp_path / "port", tm, batch_sizes=[2], depth=2,
                           hw=32)
    assert (art / "batch_stats.npz").exists()
    jm = JaxResNetSliceTrans(out_ch=2, variant=18, fusion_heads=8)
    jart = jax_save_exported(tmp_path / "jax", jm, _tree(flat),
                             batch_sizes=[2], depth=2, hw=32,
                             batch_stats=_tree(stats))
    vols = _vols(2, seed=2, hw=32)
    probs, _ = ex.load_exported(art, device="cpu").predict(vols)
    np.testing.assert_allclose(
        probs, make_predict_fn(tm, with_saliency=False)(vols)[0].numpy(),
        atol=LIVE_TOL)
    np.testing.assert_allclose(probs, jax_load_exported(jart).predict(vols)[0],
                               atol=JAX_TOL)
    # its saliency program needs a backward through the slice fusion
    with pytest.raises(NotImplementedError, match="ROADMAP queue A #14"):
        ex.save_exported(tmp_path / "sal", tm, batch_sizes=[2], depth=2,
                         hw=32, with_saliency=True)


def test_export_resnet3d_saliency(tmp_path):
    """The 3D ResNet's Grad-CAM++ program with TTA and its BatchNorm
    statistics exports (its gradient in closed form): against the live
    port, and against the JAX artifact of the same weights and statistics
    (whose program takes the gradient with `jax.grad`)."""
    tm, flat, stats = _resnet(ResNet3DClassifier, 1)
    kw = dict(batch_sizes=[1], depth=16, hw=64, with_saliency=True,
              tta=True)
    art = ex.save_exported(tmp_path / "port", tm, **kw)
    assert (art / "batch_stats.npz").exists()
    jart = jax_save_exported(tmp_path / "jax", JaxResNet3D(out_ch=2,
                                                           variant=18),
                             _tree(flat), batch_stats=_tree(stats), **kw)
    vols = _vols(1, seed=3, hw=64, depth=16)
    probs, sal = ex.load_exported(art, device="cpu").predict(vols)
    ref_p, ref_s = make_predict_fn(tm, tta=True)(vols)
    np.testing.assert_allclose(probs, ref_p.numpy(), atol=LIVE_TOL)
    np.testing.assert_allclose(sal, ref_s.numpy(), atol=LIVE_TOL)
    jp, js = jax_load_exported(jart).predict(vols)
    assert sal.shape == js.shape == (1, 16, 64, 64)
    assert np.abs(sal).max() > 0.5
    np.testing.assert_allclose(probs, jp, atol=JAX_TOL)
    np.testing.assert_allclose(sal, js, atol=JAX_TOL * np.abs(js).max())


@pytest.mark.parametrize("static", [False, True])
def test_export_int8(static, tmp_path):
    tm, _, _ = _pair(2)
    calib = _vols(2, seed=21) if static else None
    tq = quantize_mst_int8(tm, calib)
    art = ex.save_exported(tmp_path / "port", tq, batch_sizes=[2], depth=2,
                           hw=28)
    meta = json.loads((art / "meta.json").read_text())
    assert meta["int8"] and meta["int8_static"] == static
    assert _graph_ops(art, 2) == {"ln_quant_rows": 2, "gemm_i8": 2,
                                  "mhsa": 1, "quant_rows": 1 if static else 2,
                                  "gemm_i8_residual": 2}
    loaded = ex.load_exported(art, device="cpu")
    vols = _vols(2, seed=8)
    probs, _ = loaded.predict(vols)
    np.testing.assert_allclose(
        probs, make_predict_fn(tq, with_saliency=False)(vols)[0].numpy(),
        atol=LIVE_TOL)
    # the K-major copies the GEMMs read are rebuilt from q8 at load
    inputs = loaded.program_inputs()
    q8t = [k for k in inputs if k.endswith("/q8t")]
    assert q8t and "q8t" not in "".join(loaded.params)
    assert all(torch.equal(inputs[k], inputs[k[:-1]].t()) for k in q8t)


def test_export_repointed_at_the_jax_tree(shared, tmp_path):
    """A loaded artifact re-pointed at the JAX artifact's params.npz tree
    gives the JAX artifact's probabilities, and goes back to its own. The
    JAX package exports no int8 program on the CPU (its predict fn takes
    the fused int8 path on the TPU only), so the int8 case re-points a port
    int8 artifact at a JAX-quantized tree written by the JAX artifact's
    params.npz writer, against the JAX package's fused int8 forward
    (interpret mode); the load rebuilds every q8t from that tree's q8."""
    _, art, _ = shared
    _, jm, jparams = _pair(11)  # other weights than the port artifact's
    vols = _vols(4, seed=13)
    loaded = ex.load_exported(art, device="cpu")
    own, _ = loaded.predict(vols)
    jart = jax_save_exported(tmp_path / "jax", jm, jparams, batch_sizes=[4],
                             depth=2, hw=28)
    jmeta = json.loads((jart / "meta.json").read_text())
    jtree = jax_load_params_npz(jart / "params.npz", jmeta["param_dtypes"])
    probs, _ = loaded.predict(vols, params=jtree)
    np.testing.assert_allclose(probs, jax_load_exported(jart).predict(vols)[0],
                               atol=JAX_TOL)
    assert np.abs(probs - own).max() > 1e-3
    np.testing.assert_allclose(loaded.predict(vols)[0], own, atol=0)

    # E = 128: the JAX package's fused path takes E % 128 == 0 only
    tq = quantize_mst_int8(_pair(1, "tiny128")[0])  # other weights again
    art8 = ex.save_exported(tmp_path / "port8", tq, batch_sizes=[2],
                            depth=2, hw=28)
    _, jm, jparams = _pair(12, "tiny128")
    jq = quantize_mst_params_int8(jparams)
    dtypes = jax_save_params_npz(tmp_path / "jq.npz", jq)
    jtree8 = ex._load_params_npz(tmp_path / "jq.npz", dtypes)
    loaded8 = ex.load_exported(art8, device="cpu")
    probs8, _ = loaded8.predict(vols[:2], params=jtree8)
    ref8, _ = jax_make_predict_fn(jm, with_saliency=False, force_fused=True)(
        jq, jnp.asarray(vols[:2]), None)
    np.testing.assert_allclose(probs8, np.asarray(ref8), atol=JAX_TOL)
    inputs = loaded8.program_inputs(jtree8)
    q8 = {k: v for k, v in jtree8.items() if k.endswith("/q8")}
    assert q8 and all(torch.equal(inputs[k + "t"], v.t())
                      for k, v in q8.items())


def test_params_npz_roundtrip_and_programs_hold_no_weights(tmp_path):
    tree = {"encoder": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "w_bf16": torch.arange(4, dtype=torch.bfloat16
                                               ).reshape(2, 2)},
            "head": {"q_int8": np.array([-128, 127], np.int8)}}
    path = tmp_path / "p.npz"
    dtypes = ex._save_params_npz(path, tree)
    assert dtypes == {"encoder/w_bf16": "bfloat16"}
    back = ex._load_params_npz(path, dtypes)
    assert back["encoder/w_bf16"].dtype == torch.bfloat16
    assert back["head/q_int8"].dtype == torch.int8
    assert back["encoder/w"].dtype == torch.float32
    for k, v in ex._flat(tree).items():
        assert torch.equal(torch.as_tensor(v), back[k])
    # the JAX package reads the same file, bf16 through ml_dtypes
    jback = jax_load_params_npz(path, dtypes)
    np.testing.assert_array_equal(
        np.asarray(jback["encoder"]["w_bf16"], np.float32),
        back["encoder/w_bf16"].float().numpy())

    model = DinoSliceClassifier(out_ch=2, **dict(TINY, model_size="tiny128"))
    params_from_flax(model, _flat(0, model))
    art = ex.save_exported(tmp_path / "art", model.eval(), batch_sizes=[1, 2],
                           depth=2, hw=28)
    npz = (art / "params.npz").stat().st_size
    for b in (1, 2):
        pt2 = art / f"program_b{b}.pt2"
        assert pt2.stat().st_size < npz / 4, (pt2.stat().st_size, npz)
        # no example inputs (they would be the weights): an empty entry
        sample = [i.file_size for i in zipfile.ZipFile(pt2).infolist()
                  if "sample_inputs" in i.filename]
        assert sum(sample) == 0, sample
        ep = torch.export.load(pt2)
        assert not ep.state_dict
        assert sum(t.numel() for t in ep.constants.values()) < 1000


_LOAD_ONLY = """
import sys, numpy as np
from mst_tpu_torch.export import load_exported
p = load_exported(sys.argv[1], device="cpu")
probs, _ = p.predict(np.load(sys.argv[2]))
banned = [m for m in sys.modules if m.startswith("mst_tpu_torch.models")
          or m.split(".")[0] in ("jax", "jaxlib", "flax", "mst_tpu")]
assert not banned, banned
print(repr(probs.tolist()))
"""


def test_load_without_models_or_jax(shared, tmp_path):
    tm, art, _ = shared
    vols = _vols(2, seed=17)
    np.save(tmp_path / "v.npy", vols)
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_ONLY, str(art), str(tmp_path / "v.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    probs = np.array(eval(proc.stdout.strip().splitlines()[-1]))
    np.testing.assert_allclose(
        probs, make_predict_fn(tm, with_saliency=False)(vols)[0].numpy(),
        atol=LIVE_TOL)


def _post(port, vol):
    buf = io.BytesIO()
    np.save(buf, vol)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        return json.loads(r.read())


def test_export_cli_end_to_end(tmp_path):
    """train -> `python -m mst_tpu_torch.export` -> `serve --exported` over
    HTTP: the answer equals `serve --run_folder`'s."""
    run, _ = cli.main(["--dataset", "Synthetic", "--model_size", "tiny",
                       "--fusion_heads", "4", "--dtype", "float32",
                       "--max_epochs", "1", "--batch_size", "2",
                       "--num_train_samples", "4", "--run_dir",
                       str(tmp_path / "runs")], device="cpu",
                      shape_cdhw=(1, 2, 28, 28), num_samples=4)
    art = ex.main(["--run_folder", str(run), "--out", str(tmp_path / "art"),
                   "--batch_sizes", "2", "--depth", "2", "--hw", "28",
                   "--dtype", "float32"], device="cpu")
    assert json.loads((art / "meta.json").read_text())["run_folder"] == str(
        run)
    vol = _vols(1, seed=4)[0]
    answers = {}
    for argv in (["--exported", str(art)], ["--run_folder", str(run),
                                             "--dtype", "float32"]):
        args = serve.parse_args(argv + ["--port", "0", "--batch_size", "2",
                                        "--max_wait_ms", "1"])
        if args.exported:
            server, predictor = serve.build_exported_server(
                args, ex.load_exported(args.exported, device="cpu"))
        else:
            server, predictor = serve.build_server(
                args, serve.build_model(args, device="cpu"))
        port = server.server_address[1]
        try:
            answers[argv[0]] = _post(port, vol)
            health = _health(port)
        finally:
            server.shutdown()
            server.server_close()
            predictor.close()
        assert health["ok"] and health["volumes_served"] == 1
        if args.exported:
            assert health["exported"] == str(art) and health["int8"] is None
            assert health["model"] == "DinoSliceClassifier"
    np.testing.assert_allclose(answers["--exported"]["probs"],
                               answers["--run_folder"]["probs"],
                               atol=LIVE_TOL)
    assert answers["--exported"]["pred"] == answers["--run_folder"]["pred"]
    # a batch size that is not an exported bucket, and the flags the
    # artifact fixes, stop at startup
    args = serve.parse_args(["--exported", str(art), "--batch_size", "3"])
    with pytest.raises(SystemExit):
        serve.build_exported_server(args, ex.load_exported(art, device="cpu"))
    for argv in (["--exported", str(art), "--run_folder", str(run)],
                 ["--exported", str(art), "--int8"],
                 ["--exported", str(art), "--num_devices", "2"]):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
    with pytest.raises(SystemExit):
        ex.parse_args(["--run_folder", str(run), "--out", "x",
                       "--int8_calib", "2"])


def _op_cases():
    """(name, registered op, CPU arguments) for each serving op and form."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    bf = torch.bfloat16
    m, k, n, s, h = 24, 64, 128, 12, 2
    x, ln = rand(m, k, dtype=bf), (rand(k), rand(k))
    qkv, carry = rand(2 * s, 3 * 64 * h, dtype=bf), rand(2, h, s).abs()
    rope = (rand(s, 64), rand(s, 64))
    hq, hs, q8t = codes(m, k), rand(m).abs() + 0.1, codes(n, k)
    i8 = (rand(n).abs(), rand(n))
    q = rand(2, h, 5, 64, dtype=bf)
    lse = tat.flash_fwd(q, q, q, want_lse=True)[1]
    return [
        ("ln_rows", tfb._ln_rows_op, (x, *ln, 1e-6)),
        ("gemm_act", tfb._gemm_act_op, (x, rand(k, n, dtype=bf), rand(n),
                                        tfb.ACT_GELU_ERF)),
        ("gemm_swiglu", tfb._gemm_swiglu_op, (x, rand(k, n, dtype=bf),
                                              rand(n))),
        ("gemm_residual", tfb._gemm_residual_op,
         (x, rand(k, n, dtype=bf), rand(n), rand(n), rand(m, n, dtype=bf))),
        *[(f"mhsa {form}", tfb._mhsa_op, (qkv, c, *r, 2, s, h, row, abnar))
          for form, c, r, row, abnar in (
              ("plain", None, (None, None), False, False),
              ("row", None, (None, None), True, False),
              ("carry", carry, (None, None), True, False),
              ("abnar", None, (None, None), False, True),
              ("rope", None, rope, False, False))],
        *[(f"ln_quant_rows static={st}", tfq._ln_quant_rows_op,
           (x, *ln, 1e-6, st)) for st in (False, True)],
        ("gemm_i8 qkv", tfq._gemm_i8_op,
         (hq, hs, q8t, *i8, None, tfb.ACT_NONE, False, bf)),
        ("gemm_i8 gelu", tfq._gemm_i8_op,
         (hq, hs, q8t, *i8, None, tfb.ACT_GELU_ERF, False, bf)),
        ("gemm_i8 static", tfq._gemm_i8_op,
         (hq, None, q8t, *i8, torch.tensor([[0.5]]), tfb.ACT_GELU_ERF,
          False, bf)),
        ("gemm_i8 gated", tfq._gemm_i8_op,
         (hq, hs, q8t, *i8, None, tfb.ACT_NONE, True, bf)),
        *[(f"quant_rows static={st}", tfq._quant_rows_op, (rand(m, k), st))
          for st in (False, True)],
        ("gemm_i8_residual", tfq._gemm_i8_residual_op,
         (hq, hs, q8t, *i8, rand(n), rand(m, n, dtype=bf))),
        ("flash_fwd", tat._flash_fwd_op, (q, q.clone(), q.clone(), 0.125)),
        ("flash_fwd_lse", tat._flash_fwd_lse_op,
         (q, q.clone(), q.clone(), 0.125)),
        ("flash_row", tat._flash_row_op, (q, q.clone(), lse, 0.125)),
        ("flash_carry", tat._flash_carry_op,
         (q, q.clone(), lse, rand(2, h, 5).abs(), 0.125)),
        ("flash_abnar", tat._flash_abnar_op, (q, q.clone(), lse, 0.125)),
    ]


@pytest.mark.parametrize("name,op,args", _op_cases(),
                         ids=[c[0] for c in _op_cases()])
def test_registered_op_fakes_match_their_cpu_implementation(name, op, args):
    """Each serving op's fake gives its CPU implementation's shapes, dtypes
    and strides (`flash_fwd`'s o laid out [B, S, H, hd] behind a [B, H, S,
    hd] view among them), so a traced graph lays out what the kernels
    write; its schema and registrations pass `torch.library.opcheck`."""
    del name
    torch.library.opcheck(op, args)
    if op is tat._flash_fwd_op:
        assert op(*args).transpose(1, 2).is_contiguous()
    if op is tat._flash_fwd_lse_op:
        o, lse = op(*args)
        assert o.transpose(1, 2).is_contiguous() and lse.is_contiguous()
