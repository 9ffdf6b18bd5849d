"""The artifact helpers of the port's `predict --get_segmentation` and
`--get_attention` on the CPU against `mst_tpu`:

- `utils/seg_metrics.py` (Dice, IoU, the surface mask, ASSD with
  anisotropic spacing, the 0.999-quantile mask) against
  `mst_tpu/utils/seg_metrics.py` on seeded masks, empty ones included: to
  1e-12, NaN where the JAX function gives NaN;
- `utils/functions.py`'s colormap tables against matplotlib's `gray` and
  `jet`, and the PNG files of `tensor2image`, `overlay_mask` and
  `overlay_cam` against the JAX writers' (matplotlib's `imsave`), both
  decoded with PIL: equal pixel for pixel; `read_png` reads its own files
  back."""

import matplotlib
import numpy as np
import pytest
from PIL import Image

from mst_tpu.utils import functions as jf
from mst_tpu.utils import seg_metrics as js
from mst_tpu_torch.utils import functions as tf
from mst_tpu_torch.utils import seg_metrics as ts

matplotlib.use("Agg")


def _close(a, b):
    if np.isnan(b):
        assert np.isnan(a)
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)


def _masks(seed, shape, p):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape) < p
    b = np.roll(a, 1, axis=0) | (rng.uniform(size=shape) < p / 4)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spacing", [None, (1.0, 1.0, 1.0),
                                     (2.5, 0.7, 0.7), (0.6, 1.3, 3.1)])
def test_seg_metrics_match_mst_tpu(seed, spacing):
    a, b = _masks(seed, (6, 11, 13), 0.08)
    for x, y in ((a, b), (b, a), (a, a)):
        _close(ts.dice_score(x, y), js.dice_score(x, y))
        _close(ts.iou_score(x, y), js.iou_score(x, y))
        for sym in (True, False):
            _close(ts.average_surface_distance(x, y, spacing, sym),
                   js.average_surface_distance(x, y, spacing, sym))
    np.testing.assert_array_equal(ts._surface_mask(a), js._surface_mask(a))


def test_seg_metrics_empty_masks_match_mst_tpu():
    empty = np.zeros((4, 5, 6), bool)
    full, _ = _masks(3, (4, 5, 6), 0.2)
    for x, y in ((empty, empty), (empty, full), (full, empty)):
        for f in ("dice_score", "iou_score"):
            _close(getattr(ts, f)(x, y), getattr(js, f)(x, y))
        _close(ts.average_surface_distance(x, y, (2.0, 1.0, 0.5)),
               js.average_surface_distance(x, y, (2.0, 1.0, 0.5)))
    assert np.isnan(ts.dice_score(empty, empty))
    assert np.isnan(ts.average_surface_distance(empty, full))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_saliency_to_mask_matches_mst_tpu(dtype):
    sal = np.random.default_rng(4).standard_normal((8, 28, 28)).astype(dtype)
    for q in (0.999, 0.9, 0.5):
        np.testing.assert_array_equal(ts.saliency_to_mask(sal, q),
                                      js.saliency_to_mask(sal, q))
    assert ts.saliency_to_mask(sal).sum() == 7  # above the 0.999 quantile


def test_colormap_tables_equal_matplotlibs():
    from matplotlib import cm

    for ours, ref in ((tf.GRAY_LUT, cm.gray), (tf.JET_LUT, cm.jet)):
        ref._init()
        np.testing.assert_array_equal(ours, ref._lut[:256])
    x = np.random.default_rng(5).uniform(size=(9, 31)).astype(np.float32)
    x[0, :3] = (0.0, 1.0, 0.5)
    np.testing.assert_array_equal(tf.jet(x), cm.jet(x))


def _case(seed):
    rng = np.random.default_rng(seed)
    shape = (1, 1, int(rng.integers(1, 12)), int(rng.integers(3, 20)),
             int(rng.integers(3, 20)))
    vol = (rng.standard_normal(shape) * rng.uniform(0.1, 100)).astype(
        np.float32)
    cam = rng.standard_normal(shape[2:]).astype(np.float32) ** 2
    mask = (rng.uniform(size=(1, 1) + shape[2:]) > 0.7).astype(np.uint8)
    return vol, cam, mask


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("writer", ["tensor2image", "overlay_mask",
                                    "overlay_cam"])
def test_png_writers_match_mst_tpu_pixel_for_pixel(tmp_path, seed, writer):
    vol, cam, mask = _case(seed)
    extra = {"tensor2image": (), "overlay_mask": (mask,),
             "overlay_cam": (cam,)}[writer]
    getattr(jf, writer)(vol, *extra, tmp_path / "jax.png")
    getattr(tf, writer)(vol, *extra, tmp_path / "port.png")
    ref = Image.open(tmp_path / "jax.png")
    ours = Image.open(tmp_path / "port.png")
    assert ours.mode == ref.mode == "RGBA" and ours.size == ref.size
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    np.testing.assert_array_equal(tf.read_png(tmp_path / "port.png"),
                                  np.asarray(ref))


def test_constant_volume_and_read_png_refusals(tmp_path):
    """A constant slab normalises to 0 (matplotlib's vmin == vmax case);
    `read_png` refuses a file that is not its own kind."""
    vol = np.full((1, 1, 2, 5, 7), 3.0, np.float32)
    jf.tensor2image(vol, tmp_path / "jax.png")
    tf.tensor2image(vol, tmp_path / "port.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path /
                                                        "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tf.read_png(tmp_path / "bad.png")
    Image.fromarray(np.zeros((3, 4), np.uint8)).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="RGBA"):
        tf.read_png(tmp_path / "gray.png")
