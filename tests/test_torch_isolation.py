"""The port stands alone: it imports no JAX stack (serving, training, the
data path, the `last` train state, the profiler trace, the pretrained
converters and the decode-cache tool) and none of pandas, h5py and
nibabel, ships its CUDA
sources, keeps its build output out of git, and refuses what it does not
port."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mst_tpu_torch import predict
from mst_tpu_torch.data.fixtures import DUKE_FIXTURE
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.registry import get_dataset, get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)

_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mst_tpu", "pandas",
             "h5py", "nibabel"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
import mst_tpu_torch.serve, mst_tpu_torch.registry, mst_tpu_torch.predict
import mst_tpu_torch.ops.saliency, mst_tpu_torch.utils.nifti
import mst_tpu_torch.data.datamodule, mst_tpu_torch.data.native_io
import mst_tpu_torch.data.fixtures
import mst_tpu_torch.data.datasets.lidc, mst_tpu_torch.data.datasets.duke
import mst_tpu_torch.data.datasets.mrnet
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.registry import get_dataset, get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn
model = get_model("DinoV2ClassifierSlice", model_size="tiny",
                  fusion_heads=4)
params_from_flax(model, random_flax_params(model, 0))
vol = np.random.default_rng(0).standard_normal((1, 1, 2, 28, 28))
for mode in ("last", "rollout", "rollout_abnar"):
    probs, sal = make_predict_fn(model, plane_mode=mode)(vol.astype(np.float32))
    assert probs.shape == (1, 2) and bool(torch.isfinite(probs).all())
    assert sal.shape == (1, 2, 28, 28) and bool(torch.isfinite(sal).all())
v3 = get_model("DinoV3ClassifierSlice", model_size="tiny", fusion_heads=4)
params_from_flax(v3, random_flax_params(v3, 0))
probs, sal = make_predict_fn(v3, plane_mode="rollout")(
    np.zeros((1, 1, 2, 32, 32), np.float32))
assert sal.shape == (1, 2, 32, 32) and bool(torch.isfinite(sal).all())
from mst_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step
state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
before = model.head.kernel.detach().clone()
loss, logits = make_train_step(state)(
    torch.from_numpy(vol.astype(np.float32)), torch.tensor([1]))
assert bool(torch.isfinite(loss)) and logits.shape == (1, 2)
assert not torch.equal(model.head.kernel.detach(), before)
g2 = get_model("DinoV2ClassifierSlice", model_size="tiny128", fusion_heads=4,
               ffn_layer="swiglu", freeze=True)
params_from_flax(g2, random_flax_params(g2, 0))
enc = [p.detach().clone() for p in g2.encoder.parameters()]
state = TrainState(g2, make_optimizer(g2.parameters(), 1e-3))
loss, _ = make_train_step(state)(
    torch.from_numpy(vol.astype(np.float32)), torch.tensor([1]))
assert bool(torch.isfinite(loss))
assert all(torch.equal(a, b) for a, b in zip(enc, g2.encoder.parameters()))
g2u = get_model("DinoV2ClassifierSlice", model_size="tiny128", fusion_heads=4,
                ffn_layer="swiglu", ffn_hidden=64, remat=True)
params_from_flax(g2u, random_flax_params(g2u, 0))
w12 = g2u.encoder.blocks_0.mlp.w12.kernel.detach().clone()
state = TrainState(g2u, make_optimizer(g2u.parameters(), 1e-3))
loss, _ = make_train_step(state)(
    torch.from_numpy(vol.astype(np.float32)), torch.tensor([1]))
assert bool(torch.isfinite(loss))
assert not torch.equal(w12, g2u.encoder.blocks_0.mlp.w12.kernel.detach())
from mst_tpu_torch.data.datasets.duke import DUKE_Dataset3D
from mst_tpu_torch.data.fixtures import DUKE_FIXTURE
sample = DUKE_Dataset3D(DUKE_FIXTURE, split="val")[0]
assert sample["source"].shape == (1, 32, 224, 224)
import tempfile
from pathlib import Path
from mst_tpu_torch.utils.checkpoint import restore_train_state, save_train_state
from mst_tpu_torch.utils.profiling import trace
from mst_tpu_torch.models.convert import (
    convert_any_dinov2, convert_reference_mst, dinov3_config_from_sd,
    load_pretrained_encoder, load_torch_state_dict)
import mst_tpu_torch.tools.warm_decode_cache
with tempfile.TemporaryDirectory() as d:
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3,
                                             schedule="warmup_cosine"))
    with trace(d):
        make_train_step(state)(torch.from_numpy(vol.astype(np.float32)),
                               torch.tensor([1]))
    assert list(Path(d).glob("trace_*.json"))
    save_train_state(d, "last", state, meta={"epoch": 0})
    other = get_model("DinoV2ClassifierSlice", model_size="tiny",
                      fusion_heads=4)
    params_from_flax(other, random_flax_params(other, 1))
    back, meta = restore_train_state(d, "last", TrainState(
        other, make_optimizer(other.parameters(), 1e-3)))
    assert meta == {"epoch": 0} and back.step == state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 other.parameters()))
    m0 = state.optimizer.state[model.head.kernel]["exp_avg_sq"]
    assert torch.equal(back.optimizer.state[other.head.kernel]["exp_avg_sq"],
                       m0)
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "orbax", "mst_tpu", "pandas",
           "h5py", "nibabel") and sys.modules[m] is not None]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_jax_import_in_port_sources():
    banned = ("import jax", "from jax", "import flax", "from flax",
              "import optax", "import orbax", "from mst_tpu.", "import mst_tpu\n",
              "import pandas", "from pandas", "import h5py", "from h5py",
              "import nibabel", "from nibabel")
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "mst_tpu_torch").rglob("*.py"))]:
        text = path.read_text()
        for b in banned:
            assert b not in text, f"{path}: {b!r}"


def test_cuda_sources_ship_and_build_dir_is_ignored():
    csrc = ROOT / "mst_tpu_torch" / "csrc"
    names = {p.name for p in csrc.glob("*.cu")}
    int8 = {"ln_gemm_i8.cu", "quant_rows.cu", "gemm_i8_residual.cu"}
    flash = {"flash_fwd.cu", "flash_bwd.cu"}
    # the tools/ experiments (queue B rows 17-21): source -> the JAX tool
    tools = {"attn_variants.cu": "bench_attn_softmax",
             "attn_i8.cu": "bench_attn_i8",
             "block_tail.cu": "bench_block_fusion"}
    assert names == {"ln_gemm.cu", "mhsa.cu", "gemm_residual.cu",
                     "gemm_wgrad.cu", "gemm_dgrad.cu", "mhsa_bwd.cu", *int8,
                     *flash, *tools}
    for name in names:
        text = (csrc / name).read_text()
        # the source note names the Pallas kernel it replaces
        if name in tools:
            assert f"tools/{tools[name]}.py" in text, name
        else:
            module = ("fused_int8" if name in int8 else "attention"
                      if name in flash else "fused_block")
            assert f"mst_tpu/ops/{module}.py" in text, name
        assert 'extern "C"' in text and "cudaGetLastError" in text, name
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "/build/" in ignored


def test_unsupported_configs_raise():
    for kw in (dict(rotary="RoPE"), dict(rotary="LiRE"),
               dict(slice_fusion="average"), dict(slice_fusion="linear")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DinoSliceClassifier(**dict(TINY, **kw))
    # an encoder the card's train kernels cannot train: E = 32 (the LN
    # pullback wants E % 128 == 0, the attention a head dim of 64); the CPU
    # path trains it
    gated = DinoSliceClassifier(**dict(TINY, ffn_layer="swiglu"))
    gated.check_trainable("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A #12"):
        gated.check_trainable("cuda")
    for name in ("ResNet", "ResNetSliceTrans"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(name)
    model = DinoSliceClassifier(**TINY)
    # 23x23 patches + CLS = 530 tokens > FUSED_MAX_TOKENS: served on the
    # composed path, but its saliency is not ported yet
    big = np.zeros((1, 1, 1, 322, 322), np.float32)
    probs, _ = make_predict_fn(model, with_saliency=False)(big)
    assert probs.shape == (1, 2)
    with pytest.raises(NotImplementedError, match="FUSED_MAX_TOKENS"):
        make_predict_fn(model, with_saliency=True)(big)
    # the predict CLI's PNGs
    with pytest.raises(SystemExit):
        predict.parse_args(["--run_folder", "x", "--get_attention"])
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        make_predict_fn(model.to("meta"))(np.zeros((1, 1, 1, 28, 28),
                                                   np.float32))
    # the train CLI's reference datasets (its default LIDC among them) need
    # their folder: a clear message without --path_root, the dataset with it
    for name in ("LIDC", "DUKE", "MRNet"):
        with pytest.raises(SystemExit, match="--path_root"):
            cli.build_datamodule(cli.parse_args(["--dataset", name]), "cpu")
        with pytest.raises(ValueError, match="path_root"):
            get_dataset(name, "train")
    dm = cli.build_datamodule(cli.parse_args(
        ["--dataset", "DUKE", "--path_root", str(DUKE_FIXTURE), "--fold",
         "1", "--batch_size", "4"]), "cpu")
    assert len(dm.ds_train) == 10 and dm.ds_train.augment_config(True).flip
    assert len(next(iter(dm.train_dataloader()))["uid"]) == 4
