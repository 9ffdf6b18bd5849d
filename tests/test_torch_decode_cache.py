"""The port's decoded-volume disk cache (`decode_cache=` /
`$MST_DECODE_CACHE`, `mst_tpu_torch.data.datasets.base`) on the CPU, case
for case as `tests/test_decode_cache.py:62-242` holds the JAX package's:

- cached reads equal uncached ones, value for value;
- a hit reads no source (the decoder replaced by one that fails);
- `prefetch_decode` writes through, and the reads after it add nothing;
- an edited source is decoded again (a new entry), not served stale;
- a corrupt entry is unlinked, decoded again and written again;
- DUKE's HDF5 datasets (the committed fixture) are cached as `.npy`;
- `$MST_DECODE_CACHE` turns the cache on, and `decode_cache=False` off;
- `python -m mst_tpu_torch.tools.warm_decode_cache` checks the entries it
  claims, and exits 1 with a WARNING when the writes fail.

The JAX package's h5py-fallback case has no counterpart: the port reads
HDF5 with its native reader only (there is no h5py on the card's machine).

Two cases cross the packages, bit for bit: entries the port writes serve
`mst_tpu`'s reads with its decoders disabled, and the other way round (one
cache directory serves both). And a read-only mmap hit goes through the
port's DataModule without a warning (every consumer copies)."""

import warnings

import numpy as np
import pytest

from mst_tpu.data.datasets.base import Dataset3D as JaxDataset3D
from mst_tpu.data.datasets.duke import DUKE_Dataset3D as JaxDUKE
from mst_tpu.data.datasets.lidc import LIDC_Dataset3D as JaxLIDC
from mst_tpu_torch.data import fixtures, native_io
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets import base
from mst_tpu_torch.data.datasets.base import Dataset3D
from mst_tpu_torch.data.datasets.duke import DUKE_Dataset3D
from mst_tpu_torch.data.datasets.lidc import LIDC_Dataset3D
from mst_tpu_torch.tools import warm_decode_cache
from mst_tpu_torch.utils.nifti import write_nifti

CROP = (16, 16, 4)  # W, H, D
DUKE_CROP = (8, 8, 4)


def flush():
    Dataset3D.flush_cache_writes()
    JaxDataset3D.flush_cache_writes()


@pytest.fixture(autouse=True)
def _force_write_behind(monkeypatch):
    # the write-behind thread on any host (a 1-core host writes inline)
    monkeypatch.setenv("MST_CACHE_WRITE_BEHIND", "1")
    monkeypatch.delenv("MST_DECODE_CACHE", raising=False)


def _lidc_tree(root, n=3):
    return fixtures.write_lidc(root, n, seed=0, shape_xyz=(20, 20, 6),
                               splits=("train",))


def _lidc(root, cache):
    return LIDC_Dataset3D(root, split="train", fold=0, image_crop=CROP,
                          decode_cache=cache)


def _duke(cache, cls=DUKE_Dataset3D):
    return cls(fixtures.DUKE_FIXTURE, split="train", image_crop=DUKE_CROP,
               decode_cache=cache)


def _bomb(what):
    def fail(*a, **k):  # pragma: no cover - failure path
        raise AssertionError(f"{what} called on a cache hit: {a}")
    return fail


def test_cache_values_match_uncached(tmp_path):
    root = _lidc_tree(tmp_path / "lidc")
    cache = tmp_path / "cache"
    plain, cached = _lidc(root, False), _lidc(root, cache)
    for i in range(len(plain)):
        a, b = plain[i], cached[i]  # b fills the cache
        np.testing.assert_array_equal(a["source"], b["source"])
        np.testing.assert_array_equal(a["affine"], b["affine"])
    flush()
    assert len(list(cache.glob("*.vol.npy"))) == 2 * len(plain)  # img + seg
    again = _lidc(root, cache)
    for i in range(len(plain)):
        np.testing.assert_array_equal(plain[i]["source"], again[i]["source"])
        np.testing.assert_array_equal(plain[i]["mask"], again[i]["mask"])


def test_cache_hit_served_without_reading_source(tmp_path, monkeypatch):
    root = _lidc_tree(tmp_path / "lidc")
    cache = tmp_path / "cache"
    warm = _lidc(root, cache)
    expected = [warm[i]["source"] for i in range(len(warm))]
    flush()
    monkeypatch.setattr(base, "load_volume_dhw", _bomb("the decoder"))
    monkeypatch.setattr(native_io, "read_nifti_batch", _bomb("the decoder"))
    fresh = _lidc(root, cache)
    fresh.prefetch_decode(list(range(len(fresh))))  # every file is cached
    for i in range(len(fresh)):
        np.testing.assert_array_equal(fresh[i]["source"], expected[i])


def test_prefetch_write_through(tmp_path):
    root = _lidc_tree(tmp_path / "lidc")
    cache = tmp_path / "cache"
    ds = _lidc(root, cache)
    ds.prefetch_decode(list(range(len(ds))))
    flush()
    assert len(list(cache.glob("*.vol.npy"))) == 2 * len(ds)
    assert len(list(cache.glob("*.aff.npy"))) == 2 * len(ds)
    _ = [ds[i] for i in range(len(ds))]  # consumes the prefetch
    flush()
    assert len(list(cache.glob("*.vol.npy"))) == 2 * len(ds)
    assert not list(cache.glob("*.tmp"))
    # integral CT / segmentation volumes are stored compacted
    assert {np.load(f).dtype for f in cache.glob("*.vol.npy")} == \
        {np.dtype(np.int16), np.dtype(np.uint8)}


def test_source_edit_invalidates(tmp_path):
    root = _lidc_tree(tmp_path / "lidc", n=1)
    cache = tmp_path / "cache"
    before = _lidc(root, cache)[0]["source"].copy()
    flush()
    n_before = len(list(cache.glob("*.vol.npy")))
    img = next((root / "preprocessed_crop").rglob("img_0.nii.gz"))
    write_nifti(img, np.random.default_rng(7).normal(
        500, 10, (20, 20, 6)).astype(np.int16), np.diag([0.7, 0.7, 2.5, 1.0]))
    after = _lidc(root, cache)[0]["source"]
    flush()
    assert not np.array_equal(before, after)  # decoded again, not stale
    assert len(list(cache.glob("*.vol.npy"))) > n_before


def test_corrupt_cache_entry_recovers_and_self_heals(tmp_path, monkeypatch):
    root = _lidc_tree(tmp_path / "lidc", n=1)
    cache = tmp_path / "cache"
    expected = _lidc(root, cache)[0]["source"]
    flush()
    for f in cache.glob("*.vol.npy"):
        f.write_bytes(b"not an npy")
    np.testing.assert_array_equal(_lidc(root, cache)[0]["source"], expected)
    flush()
    # the pairs were unlinked and written again: a pure hit now
    monkeypatch.setattr(base, "load_volume_dhw", _bomb("the decoder"))
    np.testing.assert_array_equal(_lidc(root, cache)[0]["source"], expected)


def test_duke_h5_cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    plain, cached = _duke(False), _duke(cache)
    want = [plain[i] for i in range(len(plain))]
    for i, ref in enumerate(want):
        np.testing.assert_array_equal(ref["source"], cached[i]["source"])
    flush()
    assert len(list(cache.glob("*.npy"))) == 2 * len(plain)  # sub + affine
    monkeypatch.setattr(native_io, "h5_read", _bomb("the HDF5 reader"))
    monkeypatch.setattr(native_io, "h5_read_batch", _bomb("the HDF5 reader"))
    again = _duke(cache)
    again.prefetch_decode(list(range(len(again))))
    for i, ref in enumerate(want):
        np.testing.assert_array_equal(ref["source"], again[i]["source"])
        np.testing.assert_array_equal(ref["affine"], again[i]["affine"])


def test_env_var_enables_cache(tmp_path, monkeypatch):
    root = _lidc_tree(tmp_path / "lidc", n=1)
    cache = tmp_path / "env_cache"
    monkeypatch.setenv("MST_DECODE_CACHE", str(cache))
    _ = LIDC_Dataset3D(root, split="train", fold=0, image_crop=CROP)[0]
    flush()
    assert len(list(cache.glob("*.vol.npy"))) == 2
    assert _lidc(root, False)._cache_dir is None  # False wins over the env


def test_warm_tool_verifies_coverage(tmp_path, monkeypatch, capsys):
    root = _lidc_tree(tmp_path / "lidc", n=2)
    cache = tmp_path / "cache"
    rc = warm_decode_cache.main(["--dataset", "LIDC", "--path_root",
                                 str(root), "--decode_cache", str(cache),
                                 "--splits", "train"])
    out = capsys.readouterr().out
    assert rc == 0 and "2 verified cached" in out and "WARNING" not in out
    assert len(list(cache.glob("*.vol.npy"))) == 4  # img + seg per volume
    # every write fails: the tool reports the gap instead of success
    monkeypatch.setattr(Dataset3D, "_cache_put_volume",
                        classmethod(lambda cls, *a, **k: None))
    monkeypatch.setattr(Dataset3D, "_cache_put",
                        classmethod(lambda cls, *a, **k: None))
    rc = warm_decode_cache.main(["--dataset", "LIDC", "--path_root",
                                 str(root), "--decode_cache",
                                 str(tmp_path / "cache2"), "--splits",
                                 "train"])
    out = capsys.readouterr().out
    assert rc == 1 and "WARNING train: only 0/2" in out


@pytest.mark.parametrize("writer", ["mst_tpu_torch", "mst_tpu"])
def test_one_cache_serves_both_packages(tmp_path, monkeypatch, writer):
    """LIDC volumes and DUKE's HDF5 datasets cached by one package are read
    by the other with its decoders disabled, and give the samples of an
    uncached read of either package bit for bit."""
    import h5py

    import mst_tpu.data.datasets.base as jbase
    from mst_tpu.data import native_io as jnative

    root = _lidc_tree(tmp_path / "lidc")
    cache = tmp_path / "cache"
    lidc = {"mst_tpu_torch": lambda c: _lidc(root, c),
            "mst_tpu": lambda c: JaxLIDC(root, split="train", fold=0,
                                         image_crop=CROP, decode_cache=c)}
    duke = {"mst_tpu_torch": lambda c: _duke(c),
            "mst_tpu": lambda c: _duke(c, JaxDUKE)}
    reader = "mst_tpu" if writer == "mst_tpu_torch" else "mst_tpu_torch"
    want = {name: [ds[i] for i in range(len(ds))]
            for name, ds in (("lidc", lidc["mst_tpu"](False)),
                             ("duke", duke["mst_tpu"](False)))}
    for make in (lidc[writer], duke[writer]):
        ds = make(cache)
        _ = [ds[i] for i in range(len(ds))]
    flush()
    assert len(list(cache.glob("*.vol.npy"))) == 6
    if reader == "mst_tpu":
        monkeypatch.setattr(jbase, "load_volume_dhw", _bomb("the decoder"))
        monkeypatch.setattr(jnative, "h5_read", _bomb("the HDF5 reader"))
        monkeypatch.setattr(h5py, "File", _bomb("h5py"))
    else:
        monkeypatch.setattr(base, "load_volume_dhw", _bomb("the decoder"))
        monkeypatch.setattr(native_io, "h5_read", _bomb("the HDF5 reader"))
    for name, make in (("lidc", lidc[reader]), ("duke", duke[reader])):
        ds = make(cache)
        for i, ref in enumerate(want[name]):
            got = ds[i]
            for key in ("source", "affine") + (("mask",) if name == "lidc"
                                               else ()):
                assert got[key].dtype == ref[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"{name} {key}")
    flush()
    assert not list(cache.glob("*.tmp"))


def test_mmap_hits_through_the_datamodule_without_a_warning(tmp_path):
    """Warm LIDC and DUKE caches read back as read-only memory maps, and a
    val epoch of the port's DataModule over them raises no warning (a
    `torch.from_numpy` of a read-only array would) and gives the uncached
    batches."""
    root = _lidc_tree(tmp_path / "lidc", n=4)
    cache = tmp_path / "cache"
    for ds in (_lidc(root, cache), _duke(cache)):
        _ = [ds[i] for i in range(len(ds))]
    flush()
    assert not _duke(cache)._read_h5(
        fixtures.DUKE_FIXTURE / "data_compressed.h5",
        "Breast_MRI_001/sub").flags.writeable
    for make in (lambda c: _lidc(root, c), _duke):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = list(DataModule(ds_val=make(cache), batch_size=2)
                       .val_dataloader())
        want = list(DataModule(ds_val=make(False), batch_size=2)
                    .val_dataloader())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["uid"] == w["uid"]
            assert np.array_equal(g["source"].numpy(), w["source"].numpy())
