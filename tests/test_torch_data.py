"""The port's data transforms and DataModule on the CPU against `mst_tpu`.

The device ops (`mst_tpu_torch.data.transforms`) run on CPU tensors in f32
and are held against the JAX functions at the same draws (the port draws
from torch generators, JAX from threefry keys, so the tests hand both the
same angles, flags and noise):

- clamp, rescale, flips and inversion: bit for bit;
- percentile z-norm (a constant channel included), trilinear resize (up and
  down) and z-rotation (bilinear): max |port - JAX| <= 1e-5 x max |JAX|;
  the masks they move: the same voxels, but where a resized mask's value
  lies within 1e-6 of the 0.5 threshold (a summation-order tie);
- the host geometry (`crop_or_pad`, `ensure_shape_multiple`): bit for bit,
  the random centre drawn from the same numpy generator.

Sizes are a few slices of 16 x 15 px."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.data import transforms as J
from mst_tpu_torch.data import transforms as T
from mst_tpu_torch.data.datamodule import DataModule, _collate

REL = 1e-5  # max |port - JAX| / max |JAX| of the interpolating ops
TIE = 1e-6  # a resized mask value this close to 0.5 may round either way

_rotate_jit = jax.jit(J.rotate_z, static_argnums=(3,))


def _vols(seed=0, shape=(3, 2, 4, 16, 15), loc=100.0, scale=30.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(
        np.float32)


def _close(ours, ref, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, what
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= REL, f"{what}: {err}"


def test_clamp_rescale_invert_flips_are_exact():
    v = _vols(scale=900.0)
    tv = torch.from_numpy(v)
    assert np.array_equal(T.clamp(tv, -1000.0, 1000.0).numpy(),
                          np.asarray(J.clamp(jnp.asarray(v), -1000.0, 1000.0)))
    for out_range, in_range in (((-1.0, 1.0), (-1000.0, 1000.0)),
                                ((0.0, 1.0), (-200.0, 300.0))):
        ref = np.asarray(J.rescale_intensity(jnp.asarray(v), out_range,
                                             in_range))
        assert np.array_equal(T.rescale_intensity(tv, out_range,
                                                  in_range).numpy(), ref)
    flags = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]], bool)
    ref = np.stack([np.asarray(J.apply_flips(jnp.asarray(x), jnp.asarray(f)))
                    for x, f in zip(v, flags)])
    assert np.array_equal(T.apply_flips(tv, torch.from_numpy(flags)).numpy(),
                          ref)
    inv = torch.tensor([True, False, True])
    out, _ = T.apply_augment(T.AugmentConfig(), tv, None, {"invert": inv})
    ref = np.stack([np.asarray(jnp.where(f, -jnp.asarray(x), jnp.asarray(x)))
                    for x, f in zip(v, inv.numpy())])
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("percentiles", [(0.5, 99.5), (0.0, 100.0)])
def test_znorm_percentile_matches_jax(percentiles):
    v = _vols(1)
    v[1, 1] = 7.0  # a constant channel: the extremes mask falls back to all
    v[2, 0, 0, :3] = v[2, 0].min()  # repeated extremes
    ref = np.stack([np.asarray(J.znorm_percentile(jnp.asarray(x),
                                                  percentiles)) for x in v])
    ours = T.znorm_percentile(torch.from_numpy(v), percentiles).numpy()
    assert np.isfinite(ours).all()
    assert np.array_equal(ours[1, 1], ref[1, 1])  # constant -> 0
    _close(ours, ref, f"znorm {percentiles}")


@pytest.mark.parametrize("target", [(4, 24, 22), (4, 9, 7), (3, 20, 10),
                                    (6, 16, 15)])
def test_resize_trilinear_matches_jax_with_the_mask(target):
    """Up, down and mixed (antialiased when shrinking), and the identity."""
    v = _vols(2)
    ref = np.stack([np.asarray(J.resize_trilinear(jnp.asarray(x), target))
                    for x in v])
    _close(T.resize_trilinear(torch.from_numpy(v), target).numpy(), ref,
           f"resize {target}")
    mask = (np.random.default_rng(3).random((3, 1, 4, 16, 15)) > 0.5
            ).astype(np.uint8)
    mref = np.stack([np.asarray(J.resize_trilinear(
        jnp.asarray(m.astype(np.float32)), target)) for m in mask])
    mours = T.resize_trilinear(torch.from_numpy(mask).float(), target).numpy()
    _close(mours, mref, f"resized mask {target}")
    clear = np.abs(mref - 0.5) > TIE
    assert np.array_equal((mours > 0.5)[clear], (mref > 0.5)[clear])


def _source_ties(cos_t, sin_t, cos_j, sin_j, h, w):
    """[B, H, W] True where the nearest rotation's source y or x of the
    port lies so close to a .5 tie that the cos / sin of the other side,
    an ulp apart, may round it the other way: the coordinates' gap bound
    (|d cos| |y| + |d sin| |x|) plus 4 f32 ulps of the coordinate for the
    rounding of the products and sums."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (np.arange(h, dtype=np.float32) - cy)[None, :, None]
    xx = (np.arange(w, dtype=np.float32) - cx)[None, None, :]
    c, s_ = cos_t[:, None, None], sin_t[:, None, None]
    dc = np.abs(cos_t - cos_j)[:, None, None].astype(np.float64)
    ds = np.abs(sin_t - sin_j)[:, None, None].astype(np.float64)
    src_y = c * yy - s_ * xx + np.float32(cy)
    src_x = s_ * yy + c * xx + np.float32(cx)
    slop = 4 * np.spacing(np.float32(max(h, w)))
    gap_y = dc * np.abs(yy) + ds * np.abs(xx) + slop
    gap_x = ds * np.abs(yy) + dc * np.abs(xx) + slop

    def near(src, gap):
        return np.abs(np.abs(src - np.floor(src)) - 0.5) <= gap

    return near(src_y, gap_y) | near(src_x, gap_x)


@pytest.mark.parametrize("angles", [(0.3, 1.2, np.pi / 2),
                                    (0.0, 0.7853982, 1.5),
                                    (1.0, 1.1, 0.9)])
def test_rotate_z_matches_jax_with_the_mask(angles):
    """Bilinear with each volume's minimum as the fill, and the nearest mask
    with a fill of 0. At pi / 2 on a 16 x 15 plane the centre column's
    source x falls on .5 exactly: those ties round away from zero, as
    `lax.round` does. Where both sides have the same f32 cos and sin the
    coordinates agree bit for bit, and so do the masks. At 1.0, 1.1 and 0.9
    torch's and XLA's f32 cos or sin differ by an ulp, which moves the
    bilinear output by far less than the limit, and may move a nearest
    source coordinate across a .5 tie: the masks agree at every voxel but
    those whose source lies within that ulp's reach of a tie
    (`_source_ties`), the resize test's `TIE` for the rotation."""
    a = np.float32(angles)
    v = _vols(4)
    ta = torch.from_numpy(a)
    ref = np.stack([np.asarray(_rotate_jit(jnp.asarray(x), jnp.float32(g),
                                           None, False))
                    for x, g in zip(v, a)])
    _close(T.rotate_z(torch.from_numpy(v), ta).numpy(), ref, "rotate")
    mask = (np.random.default_rng(5).random((3, 1, 4, 16, 15)) > 0.5
            ).astype(np.float32)
    mref = np.stack([np.asarray(_rotate_jit(jnp.asarray(m), jnp.float32(g),
                                            0.0, True) > 0.5)
                     for m, g in zip(mask, a)])
    mours = (T.rotate_z(torch.from_numpy(mask), ta, fill=0.0, nearest=True)
             > 0.5).numpy()
    cos_t, sin_t = torch.cos(ta).numpy(), torch.sin(ta).numpy()
    cos_j = np.asarray(jnp.cos(jnp.asarray(a)))
    sin_j = np.asarray(jnp.sin(jnp.asarray(a)))
    if np.array_equal(cos_t, cos_j) and np.array_equal(sin_t, sin_j):
        assert np.array_equal(mours, mref)
        return
    assert angles == (1.0, 1.1, 0.9)
    tie = np.broadcast_to(_source_ties(cos_t, sin_t, cos_j, sin_j, 16, 15)
                          [:, None, None], mours.shape)
    assert tie.mean() < 0.05, tie.mean()  # a few voxels, not the plane
    assert np.array_equal(mours[~tie], mref[~tie])


def test_round_half_away_from_zero():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.49999997, -0.49999997,
                      3.2, -3.7], dtype=torch.float32)
    ref = np.asarray(jax.lax.round(jnp.asarray(x.numpy())))
    assert np.array_equal(T._round_half_away(x).numpy(), ref)


@pytest.mark.parametrize("name", ["LIDC", "DUKE", "MRNet"])
def test_apply_augment_matches_jax_augment_one_at_the_same_draws(name):
    """The whole device pipeline of each dataset's train config, at fixed
    draws, vs `_augment_one`'s steps composed from the JAX functions."""
    cfgs = {
        "LIDC": dict(clamp_range=(-1000.0, 1000.0),
                     rescale=((-1.0, 1.0), (-1000.0, 1000.0))),
        "DUKE": dict(znorm_percentiles=(0.5, 99.5)),
        "MRNet": dict(znorm_percentiles=(0.0, 100.0), resize_to=(4, 20, 18),
                      has_mask=True),
    }
    cfg = T.AugmentConfig(random_rotate=True, flip=True, invert=True,
                          noise_std=0.25, **cfgs[name])
    v = _vols(6, loc=0.0, scale=800.0 if name == "LIDC" else 1.0)
    mask = np.ones((3, 1, 4, 16, 15), np.uint8)
    mask[0, :, 3] = 0  # a padded slice
    draws = T.draw_augment(cfg, True, [11, 12, 13], v.shape[1:], "cpu")
    draws["angle"] = torch.tensor([0.3, 1.2, 0.7853982])
    # the noise at the post-resize shape
    shape = v.shape[1:2] + (cfg.resize_to or v.shape[2:])
    draws["noise"] = torch.from_numpy(np.random.default_rng(7).normal(
        0, 0.1, (3, *shape)).astype(np.float32))
    ours, omask = T.apply_augment(
        cfg, torch.from_numpy(v), torch.from_numpy(mask) if cfg.has_mask
        else None, draws)
    for i in range(3):
        x, m = jnp.asarray(v[i]), jnp.asarray(mask[i])
        if cfg.clamp_range:
            x = J.clamp(x, *cfg.clamp_range)
        if cfg.rescale:
            x = J.rescale_intensity(x, *cfg.rescale)
        if cfg.resize_to:
            x = J.resize_trilinear(x, cfg.resize_to)
            m = J.resize_trilinear(m.astype(jnp.float32), cfg.resize_to) > 0.5
        if cfg.znorm_percentiles:
            x = J.znorm_percentile(x, cfg.znorm_percentiles)
        ang = jnp.float32(draws["angle"][i].item())
        x = _rotate_jit(x, ang, None, False)
        m = _rotate_jit(m.astype(jnp.float32), ang, 0.0, True) > 0.5
        flags = jnp.asarray(draws["flip"][i].numpy())
        x, m = J.apply_flips(x, flags), J.apply_flips(m, flags)
        x = jnp.where(bool(draws["invert"][i]), -x, x)
        x = x + jnp.asarray(draws["noise"][i].numpy())
        _close(ours[i].numpy(), np.asarray(x), f"{name} volume {i}")
        if cfg.has_mask:
            assert np.array_equal(omask[i].numpy(), np.asarray(m))


def test_draws_repeat_per_seed_and_stay_in_range():
    cfg = T.AugmentConfig(random_rotate=True, flip=True, invert=True,
                          noise_std=0.25)
    a = T.draw_augment(cfg, True, [1, 2, 3, 4], (1, 2, 5, 6), "cpu")
    b = T.draw_augment(cfg, True, [1, 2, 3, 4], (1, 2, 5, 6), "cpu")
    assert set(a) == {"angle", "flip", "invert", "noise"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["angle"].shape == (4,) and a["flip"].shape == (4, 3)
    assert bool(((a["angle"] >= 0) & (a["angle"] < np.pi / 2)).all())
    assert a["noise"].shape == (4, 1, 2, 5, 6)
    assert not torch.equal(a["noise"][0], a["noise"][1])
    assert T.draw_augment(cfg, False, [1], (1, 2, 5, 6), "cpu") == {}
    # only what the config turns on is drawn
    assert set(T.draw_augment(T.AugmentConfig(flip=True), True, [1],
                              (1, 1, 1, 1), "cpu")) == {"flip"}


def _crop_cases():
    rng = np.random.default_rng(8)
    vol = rng.normal(0, 1, (1, 7, 12, 9)).astype(np.float32)
    mask = np.zeros((1, 7, 12, 9), np.uint8)
    mask[0, 2:4, 7:10, 1:3] = 1
    return vol, mask, (rng.random((1, 7, 12, 9)) > 0.5).astype(np.uint8)


@pytest.mark.parametrize("kw", [
    dict(target=(4, 6, 5)), dict(target=(9, 16, 11)),
    dict(target=(4, 16, 5), mask=True), dict(target=(4, 6, 5), mask=True,
                                              extra=True),
    dict(target=(9, 6, 13), random_center=True),
    dict(target=(9, 6, 13), random_center=True, mask=True, extra=True),
    dict(target=(9, 14, 13), pad_value=-1024.0)])
def test_crop_or_pad_matches_jax_bit_for_bit(kw):
    vol, mask, extra = _crop_cases()
    args = dict(mask=mask if kw.get("mask") else None,
                random_center=kw.get("random_center", False),
                pad_value=kw.get("pad_value"),
                extra=[extra] if kw.get("extra") else ())
    ours = T.crop_or_pad(vol, kw["target"], rng=np.random.default_rng(3),
                         **args)
    ref = J.crop_or_pad(vol, kw["target"], rng=np.random.default_rng(3),
                        **args)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and np.array_equal(o, r)


@pytest.mark.parametrize("method", ["pad", "crop"])
def test_ensure_shape_multiple_matches_jax(method):
    vol, _, extra = _crop_cases()
    for mult in (4, (2, 5, 4)):
        ours = T.ensure_shape_multiple(vol, mult, method, extra=[extra])
        ref = J.ensure_shape_multiple(vol, mult, method, extra=[extra])
        for o, r in zip(ours, ref):
            assert np.array_equal(o, r)


class _Masked:
    """A tiny in-memory dataset whose samples pad their last slices."""

    def __init__(self, n=5, has_mask=True, fail_at=None):
        self.n, self.has_mask, self.fail_at = n, has_mask, fail_at
        self.served = 0

    def __len__(self):
        return self.n

    def labels(self):
        return np.arange(self.n) % 2

    def augment_config(self, train):
        return T.AugmentConfig(flip=True, has_mask=self.has_mask)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise IOError(f"case {i}: unreadable")
        self.served += 1
        mask = np.ones((1, 6, 8, 8), np.uint8)
        mask[:, 6 - (i % 3):] = 0  # the last i % 3 slices are padding
        return {"uid": f"c{i}", "source": np.full((1, 6, 8, 8), i, np.float32),
                "target": i % 2, "mask": mask, "needs_padding_mask": True}


def test_padding_mask_rides_through_the_flips():
    """`src_key_padding_mask` [B, D] bool True on the padded slices, after
    the same D flip as the volume; without `has_mask` the JAX ValueError."""
    dm = DataModule(ds_train=_Masked(), ds_val=_Masked(), batch_size=2,
                    num_train_samples=4)
    for batch in dm.train_dataloader():
        pad = batch["src_key_padding_mask"]
        assert pad.dtype == torch.bool and pad.shape == (2, 6)
        assert torch.equal(pad, ~(batch["mask"][:, 0].sum((-1, -2)) > 0))
        for b, uid in enumerate(batch["uid"]):
            k = int(uid[1:]) % 3
            assert int(pad[b].sum()) == k
    val = list(dm.val_dataloader())
    assert [len(b["uid"]) for b in val] == [2, 2, 1]
    for batch in val:  # no flips outside training: the last slices pad
        for b, uid in enumerate(batch["uid"]):
            k = int(uid[1:]) % 3
            want = torch.zeros(6, dtype=torch.bool)
            want[6 - k:] = k > 0
            assert torch.equal(batch["src_key_padding_mask"][b], want)
    bad = DataModule(ds_val=_Masked(has_mask=False), batch_size=2)
    with pytest.raises(ValueError, match="has_mask=False"):
        list(bad.val_dataloader())


def test_loader_surfaces_errors_and_stops_when_abandoned():
    dm = DataModule(ds_val=_Masked(n=8, fail_at=5), batch_size=2)
    with pytest.raises(IOError, match="case 5"):
        list(dm.val_dataloader())
    ds = _Masked(n=64)
    dm = DataModule(ds_val=ds, batch_size=2)
    it = dm.val_dataloader()
    next(it)
    before = {t.name for t in threading.enumerate()}
    assert "mst-loader" in before
    it.close()  # the consumer stops early (limit_val_batches)
    for t in threading.enumerate():
        if t.name == "mst-loader":
            t.join(timeout=5)
            assert not t.is_alive()
    assert ds.served < 64


def test_collate_keeps_the_sample_keys():
    samples = [{"uid": i, "source": np.zeros((1, 2, 3, 3), np.float32),
                "target": i, "mask": np.ones((1, 2, 3, 3), np.uint8),
                "affine": np.eye(4), "spacing_dhw": np.array([1.0, 2, 3]),
                "path": f"p{i}", "needs_padding_mask": True,
                "rater_masks": np.zeros((2, 1, 2, 3, 3), np.uint8)}
               for i in range(2)]
    b = _collate(samples)
    assert b["mask"].shape == (2, 1, 2, 3, 3)
    assert b["affine"].shape == (2, 4, 4)
    assert b["spacing_dhw"].shape == (2, 3)
    assert b["path"] == ["p0", "p1"] and len(b["rater_masks"]) == 2
    assert b["needs_padding_mask"] is True
    assert b["target"].dtype == np.int32


class _Decoded(_Masked):
    """Records the chunks the loader asks it to decode ahead."""

    def __init__(self, n=7, fail_chunk=None):
        super().__init__(n)
        self.decoded, self.fail_chunk = [], fail_chunk

    def prefetch_decode(self, chunk):
        if chunk == self.fail_chunk:
            raise IOError("decode failed")
        self.decoded.append(list(chunk))


def test_loader_decodes_each_chunk_once_in_order():
    ds = _Decoded()
    dm = DataModule(ds_val=ds, batch_size=3)
    uids = [b["uid"] for b in dm.val_dataloader()]
    assert ds.decoded == [[0, 1, 2], [3, 4, 5], [6]]
    assert uids == [["c0", "c1", "c2"], ["c3", "c4", "c5"], ["c6"]]
    with pytest.raises(IOError, match="decode failed"):
        list(DataModule(ds_val=_Decoded(fail_chunk=[3, 4, 5]),
                        batch_size=3).val_dataloader())
