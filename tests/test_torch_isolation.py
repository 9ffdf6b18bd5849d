"""The port stands alone: it imports no JAX stack (serving and training),
ships its CUDA sources, keeps its build output out of git, and refuses what
it does not port."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.registry import get_dataset, get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)

_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mst_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
import mst_tpu_torch.serve, mst_tpu_torch.registry
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.registry import get_dataset, get_model
from mst_tpu_torch.train import cli
from mst_tpu_torch.train.predictor import make_predict_fn
model = get_model("DinoV2ClassifierSlice", model_size="tiny",
                  fusion_heads=4)
params_from_flax(model, random_flax_params(model, 0))
vol = np.random.default_rng(0).standard_normal((1, 1, 2, 28, 28))
probs, _ = make_predict_fn(model)(vol.astype(np.float32))
assert probs.shape == (1, 2) and bool(torch.isfinite(probs).all())
from mst_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step
state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
before = model.head.kernel.detach().clone()
loss, logits = make_train_step(state)(
    torch.from_numpy(vol.astype(np.float32)), torch.tensor([1]))
assert bool(torch.isfinite(loss)) and logits.shape == (1, 2)
assert not torch.equal(model.head.kernel.detach(), before)
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "orbax", "mst_tpu")
          and sys.modules[m] is not None]
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
              "import optax", "import orbax", "from mst_tpu.", "import mst_tpu\n")
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "mst_tpu_torch").rglob("*.py"))]:
        text = path.read_text()
        for b in banned:
            assert b not in text, f"{path}: {b!r}"


def test_cuda_sources_ship_and_build_dir_is_ignored():
    csrc = ROOT / "mst_tpu_torch" / "csrc"
    names = {p.name for p in csrc.glob("*.cu")}
    assert names == {"ln_gemm.cu", "mhsa.cu", "gemm_residual.cu",
                     "gemm_wgrad.cu", "gemm_dgrad.cu", "mhsa_bwd.cu"}
    for name in names:
        text = (csrc / name).read_text()
        # the source note names the Pallas kernel it replaces
        assert "mst_tpu/ops/fused_block.py" in text, name
        assert 'extern "C"' in text and "cudaGetLastError" in text, name
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "/build/" in ignored


def test_unsupported_configs_raise():
    for kw in (dict(use_rope_2d=True), dict(use_pos_embed=False),
               dict(rotary="RoPE"), dict(slice_fusion="average"),
               dict(model_size="giant2")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DinoSliceClassifier(**dict(TINY, **kw))
    for name in ("DinoV3ClassifierSlice", "ResNet", "ResNetSliceTrans"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(name)
    model = DinoSliceClassifier(**TINY)
    with pytest.raises(NotImplementedError, match="saliency"):
        make_predict_fn(model, with_saliency=True)
    # 23x23 patches + CLS = 530 tokens > FUSED_MAX_TOKENS
    big = np.zeros((1, 1, 1, 322, 322), np.float32)
    with pytest.raises(NotImplementedError, match="FUSED_MAX_TOKENS"):
        make_predict_fn(model)(big)
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        make_predict_fn(model.to("meta"))(np.zeros((1, 1, 1, 28, 28),
                                                   np.float32))
    # the train CLI: the reference datasets (its default LIDC among them)
    for name in ("LIDC", "DUKE", "MRNet"):
        with pytest.raises(NotImplementedError, match="queue A #5"):
            cli.build_datamodule(cli.parse_args(["--dataset", name]), "cpu")
        with pytest.raises(NotImplementedError, match="queue A #5"):
            get_dataset(name, "train")
