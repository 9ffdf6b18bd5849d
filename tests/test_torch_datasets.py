"""The port's datasets, native reader and DataModule batches on the CPU
against `mst_tpu` (pandas, h5py and the JAX DataModule), on files the
tests write (`mst_tpu_torch.data.fixtures`) and the committed DUKE fixture
(`tests/fixtures/duke`, written by h5py from `fixtures.duke_arrays`).

Tolerances: the split tables (but float cells, 1e-12 relative: pandas' C
parser does not round every decimal correctly), the row orders, every key
of each dataset's
`__getitem__` and the native reads are bit for bit; a val batch's volumes
are within 1e-5 x max |JAX| (the z-norm's and resize's summation order),
its `src_key_padding_mask` exact; the tiny model on MRNet batches: eval
logits within 1e-4, one train step's loss and grads within 5e-4 of the
flax model and the JAX `make_train_step` with the padding mask."""

import csv

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import mst_tpu.data.native_io as jax_native
from mst_tpu.data.datamodule import DataModule as JaxDataModule
from mst_tpu.data.datasets.base import Dataset3D as JaxDataset3D
from mst_tpu.data.datasets.duke import DUKE_Dataset3D as JaxDUKE
from mst_tpu.data.datasets.lidc import LIDC_Dataset3D as JaxLIDC
from mst_tpu.data.datasets.mrnet import MRNet_Dataset3D as JaxMRNet
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu.utils.nifti import read_nifti as jax_read_nifti
from mst_tpu_torch.data import fixtures, native_io
from mst_tpu_torch.data.datamodule import DataModule
from mst_tpu_torch.data.datasets.base import Dataset3D, SplitTable
from mst_tpu_torch.data.datasets.duke import DUKE_Dataset3D
from mst_tpu_torch.data.datasets.lidc import LIDC_Dataset3D
from mst_tpu_torch.data.datasets.mrnet import MRNet_Dataset3D
from mst_tpu_torch.models.convert import params_from_flax
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import mst_logits
from mst_tpu_torch.registry import get_dataset
from mst_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step
from mst_tpu_torch.utils.nifti import read_nifti, write_nifti

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
REL = 1e-5
DUKE = fixtures.DUKE_FIXTURE


@pytest.fixture(scope="module")
def lidc_root(tmp_path_factory):
    return fixtures.write_lidc(tmp_path_factory.mktemp("lidc"), 6,
                               shape_xyz=(40, 36, 12))


@pytest.fixture(scope="module")
def mrnet_root(tmp_path_factory):
    return fixtures.write_mrnet(tmp_path_factory.mktemp("mrnet"), 9,
                                hw=(40, 36), slices=(20, 44))


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _same_samples(ours, ref, indices):
    for i in indices:
        a, b = ours[i], ref[i]
        assert set(a) == set(b), i
        for k in a:
            _assert_same(a[k], b[k], f"sample {i} key {k}")


def _write_split(path, header, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


@pytest.mark.parametrize("fraction", [None, 0.5, 0.35, 1.0])
@pytest.mark.parametrize("split", [None, "train", "test"])
def test_load_split_matches_pandas(tmp_path, split, fraction):
    """Fold, then Split, then `df.sample(frac, random_state=0)
    .reset_index()`: the same labels, columns, values and types."""
    rng = np.random.default_rng(0)
    rows = [[f"P{i:03d}", f"1.2.{i}", i % 4, float(rng.random()),
             "" if i % 7 == 0 else float(i), i % 2, int(rng.integers(0, 2)),
             ["train", "val", "test"][i % 3]] for i in range(40)]
    p = tmp_path / "split.csv"
    _write_split(p, ["patient_id", "uid", "nodule_idx", "score", "gaps",
                     "Malignant", "Fold", "Split"], rows)
    ours = Dataset3D.load_split(p, fold=1, split=split, fraction=fraction)
    ref = JaxDataset3D.load_split(p, fold=1, split=split, fraction=fraction)
    assert ours.index.tolist() == ref.index.tolist()
    assert list(ours.columns) == list(ref.columns)
    for name in ref.columns:
        a, b = ours[name], ref[name].to_numpy()
        assert a.dtype == b.dtype, name
        if a.dtype == np.float64:
            # pandas' C parser does not round every decimal correctly,
            # Python's float() does: a few ulps apart
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0,
                                       err_msg=name)
            assert np.array_equal(np.isnan(a), np.isnan(b)), name
        else:
            assert a.tolist() == b.tolist(), name
    for label in ref.index:
        row = ours.loc(label)
        for k, v in ref.loc[label].items():
            if isinstance(v, str) or k in ("nodule_idx", "Fold", "index"):
                assert str(row[k]) == str(v), (label, k)


@pytest.mark.parametrize("n", [7, 16, 17, 40, 301])
def test_mrnet_order_with_ties_matches_pandas(tmp_path, n):
    """`sort_values(LABEL, ascending=False)` on 0 / 1 labels: pandas'
    unstable quicksort order, which decides the file index i reads."""
    rng = np.random.default_rng(n)
    rows = [[i, int(rng.integers(0, 2)), int(rng.integers(0, 2)), 0,
             "train/", "train"] for i in range(n)]
    _write_split(tmp_path / "preprocessed" / "splits" / "split.csv",
                 ["ID", "abnormal", "meniscus", "Fold", "Folder", "Split"],
                 rows)
    for label in (None, "abnormal"):
        ours = MRNet_Dataset3D(tmp_path, split="train", label=label)
        ref = JaxMRNet(tmp_path, split="train", label=label)
        assert ours.df["ID"].tolist() == ref.df["ID"].tolist()
        assert ours.item_pointers == ref.item_pointers
        np.testing.assert_array_equal(ours.labels(), ref.labels())
        np.testing.assert_array_equal(ours.class_counts(), ref.class_counts())


def test_duke_fixture_reads_the_same_through_h5py_and_h5lite():
    """The committed fixture: gzip + shuffle chunks, as h5py wrote them from
    the seeded arrays; the native reader returns the same bits."""
    want = fixtures.duke_arrays()
    path = DUKE / "data_compressed.h5"
    assert path.stat().st_size <= 200_000
    with h5py.File(path, "r") as f:
        for pid, (vol, aff) in want.items():
            d = f[pid]["sub"]
            assert d.compression == "gzip" and d.shuffle and d.chunks
            _assert_same(d[()], vol, pid)
            _assert_same(f[pid]["sub_affine"][()], aff, pid)
    items = [(path, f"{pid}/{k}") for pid in want for k in ("sub",
                                                            "sub_affine")]
    outs = native_io.h5_read_batch(items, num_threads=3)
    for (pid, (vol, aff)), v, a in zip(want.items(), outs[::2], outs[1::2]):
        _assert_same(v, vol, pid)
        _assert_same(a, aff, pid)
        _assert_same(native_io.h5_read(path, f"{pid}/sub"), vol, pid)
    with open(DUKE / "splits" / "split.csv", newline="") as f:
        assert list(csv.reader(f))[1:] == [
            [str(v) for v in r] for r in fixtures.duke_split_rows()]


@pytest.mark.parametrize("split", [None, "train", "test"])
def test_duke_matches_jax_dataset(split):
    """Deduplication, the UID format and every key of every sample (the
    JAX dataset reads through h5py or its own h5lite build)."""
    kw = dict(split=split, random_center=True, seed=4)
    ours, ref = DUKE_Dataset3D(DUKE, **kw), JaxDUKE(DUKE, decode_cache=False,
                                                     **kw)
    assert len(ours) == len(ref) and ours.item_pointers == ref.item_pointers
    assert ours.df["UID"].tolist() == ref.df["UID"].tolist()
    np.testing.assert_array_equal(ours.labels(), ref.labels())
    ours.prefetch_decode([0, 1], num_threads=2)
    assert len(ours._decode_cache) == 4
    _same_samples(ours, ref, range(len(ours)))
    assert not ours._decode_cache  # drained by __getitem__


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("random_center", [False, True])
def test_lidc_matches_jax_dataset(lidc_root, split, random_center):
    """The mask-centred crop, the H / W swap, the rater masks on the test
    split and the spacing: every key bit for bit."""
    kw = dict(split=split, random_center=random_center, seed=2)
    ours, ref = LIDC_Dataset3D(lidc_root, **kw), JaxLIDC(
        lidc_root, decode_cache=False, **kw)
    assert ours.item_pointers == ref.item_pointers
    ours.prefetch_decode(list(range(len(ours))))
    _same_samples(ours, ref, range(len(ours)))
    s = ours[0]
    assert s["source"].shape == (1, 32, 224, 224)
    if split == "test":
        assert s["rater_masks"].shape == (2, 1, 32, 224, 224)


@pytest.mark.parametrize("fraction", [None, 0.5])
def test_mrnet_matches_jax_dataset(mrnet_root, fraction):
    root, counts = mrnet_root
    kw = dict(split="train", fraction=fraction)
    ours, ref = MRNet_Dataset3D(root, **kw), JaxMRNet(root, decode_cache=False,
                                                      **kw)
    assert ours.item_pointers == ref.item_pointers
    _same_samples(ours, ref, range(len(ours)))
    for i in range(len(ours)):
        s = ours[i]
        real = int(s["mask"][0].any(axis=(1, 2)).sum())
        assert real == min(32, counts[s["uid"]]), i


def test_native_reader_matches_jax_binding_and_numpy(tmp_path):
    """read_nifti / read_nifti_batch vs `mst_tpu.data.native_io` and the
    numpy reader, every dtype; the library is built into build/
    mst_tpu_torch, not native/."""
    rng = np.random.default_rng(0)
    paths = []
    for i, dt in enumerate((np.int16, np.uint8, np.float32, np.uint16,
                            np.float64)):
        aff = np.diag([0.7, 0.8, 2.0, 1.0])
        aff[:3, 3] = [4, 5, i]
        p = tmp_path / f"v{i}.nii{'.gz' if i % 2 else ''}"
        write_nifti(p, rng.normal(100, 50, (9, 11, 7)).astype(dt), aff)
        paths.append(p)
    assert native_io.library_path().parent.parts[-2:] == ("build",
                                                           "mst_tpu_torch")
    batch = native_io.read_nifti_batch(paths, num_threads=3)
    for p, (vol, aff) in zip(paths, batch):
        ref_vol, ref_aff = jax_native.read_nifti(p)
        _assert_same(vol, ref_vol, p)
        _assert_same(aff, ref_aff, p)
        _assert_same(native_io.read_nifti(p)[0], vol, p)
        data, a = read_nifti(p)
        jdata, ja = jax_read_nifti(p)
        _assert_same(data, jdata, p)
        _assert_same(a, ja, p)
        _assert_same(vol, np.transpose(data, (2, 1, 0)).astype(np.float32), p)
    with pytest.raises(IOError, match="missing"):
        native_io.read_nifti_batch([paths[0], tmp_path / "missing.nii"])
    with pytest.raises(IOError):
        native_io.h5_read(DUKE / "data_compressed.h5", "Breast_MRI_999/sub")


def test_native_build_failure_raises_with_the_compiler_output(tmp_path,
                                                              monkeypatch):
    """No quiet fallback: a source that does not compile raises with g++'s
    message, and nothing is left in the build folder."""
    for name in native_io.SOURCES:
        (tmp_path / name).write_text("this is not C++;\n")
    monkeypatch.setattr(native_io, "NATIVE", tmp_path)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native_io.read_nifti(tmp_path / "x.nii")
    assert not list((tmp_path / "build").iterdir())


def test_registry_builds_the_reference_datasets(lidc_root, mrnet_root):
    assert isinstance(get_dataset("LIDC", "val", path_root=lidc_root),
                      LIDC_Dataset3D)
    assert isinstance(get_dataset("MRNet", "val", path_root=mrnet_root[0]),
                      MRNet_Dataset3D)
    ds = get_dataset("DUKE", "train", path_root=DUKE, fold=1, flip=True,
                     random_rotate=True, random_center=True, noise=True)
    assert isinstance(ds, DUKE_Dataset3D) and len(ds) == 10
    cfg = ds.augment_config(True)
    assert cfg.random_rotate and cfg.flip and cfg.invert
    for name in ("LIDC", "DUKE", "MRNet"):
        with pytest.raises(ValueError, match="path_root"):
            get_dataset(name, "train")


def _val_batches(ours_ds, ref_ds, bs=2):
    ours = DataModule(ds_val=ours_ds, batch_size=bs, device="cpu")
    ref = JaxDataModule(ds_val=ref_ds, batch_size=bs)
    return zip(ours.val_dataloader(), ref.val_dataloader())


@pytest.mark.parametrize("name", ["LIDC", "DUKE", "MRNet"])
def test_val_batches_match_jax_datamodule(name, lidc_root, mrnet_root):
    """Every val batch of both DataModules: the device pipeline's volumes
    within 1e-5 x max |JAX|, the padding mask exact."""
    if name == "LIDC":
        ours, ref = (LIDC_Dataset3D(lidc_root, split="val"),
                     JaxLIDC(lidc_root, split="val", decode_cache=False))
    elif name == "DUKE":
        ours, ref = (DUKE_Dataset3D(DUKE, split="val"),
                     JaxDUKE(DUKE, split="val", decode_cache=False))
    else:  # every case: some have fewer than 32 slices
        ours, ref = (MRNet_Dataset3D(mrnet_root[0]),
                     JaxMRNet(mrnet_root[0], decode_cache=False))
    padded = 0
    for a, b in _val_batches(ours, ref, bs=3):
        assert a["uid"] == b["uid"]
        src, want = a["source"].numpy(), np.asarray(b["source"])
        assert src.shape == want.shape and src.dtype == np.float32
        assert np.abs(src - want).max() <= REL * np.abs(want).max()
        np.testing.assert_array_equal(a["target"], b["target"])
        for key in ("affine", "spacing_dhw"):
            np.testing.assert_array_equal(a[key], b[key])
        if name == "MRNet":
            pad = a["src_key_padding_mask"]
            assert pad.dtype == torch.bool and pad.shape == (len(a["uid"]), 32)
            np.testing.assert_array_equal(
                pad.numpy(), np.asarray(b["src_key_padding_mask"]))
            real = [min(32, mrnet_root[1][u]) for u in a["uid"]]
            assert (~pad).sum(1).tolist() == real
            padded += int(pad.any())
        else:
            assert "src_key_padding_mask" not in a
    assert padded or name != "MRNet"


def test_tiny_model_on_mrnet_batches_matches_flax_and_the_jax_step(
        mrnet_root):
    """The slice as a whole: MRNet files -> the port's DataModule (padding
    mask from the device pipeline) -> the tiny model's eval logits (1e-4)
    and one AdamW step's loss and grads (5e-4) vs the JAX DataModule's
    batch -> flax `apply` and the JAX `make_train_step` with the mask."""
    root = mrnet_root[0]
    a, b = next(iter(_val_batches(
        MRNet_Dataset3D(root, split="train"),
        JaxMRNet(root, split="train", decode_cache=False))))
    mask = a["src_key_padding_mask"]
    assert mask.any()
    jm = JaxMST(out_ch=2, use_flash=False, **TINY)
    x = np.asarray(b["source"])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :, :2]),
                     jnp.asarray(np.asarray(b["src_key_padding_mask"])[:, :2])
                     )["params"]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(0)
    for k in flat:
        if k.endswith("/gamma"):  # O(1) LayerScale: every block counts
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    tm = params_from_flax(DinoSliceClassifier(out_ch=2, **TINY), flat)
    jmask = jnp.asarray(np.asarray(b["src_key_padding_mask"]))
    ref = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), jmask))
    with torch.no_grad():
        ours = mst_logits(tm, a["source"], mask).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)

    lr = 1e-3
    t = np.asarray(b["target"])
    # the grads at these weights (before the step, which donates them)
    jflat = flatten_dict(jax.grad(lambda p: _ce(jm, p, x, t, jmask))(tree),
                         sep="/")
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=tree,
                                  tx=jax_make_optimizer(lr, 1e-2),
                                  dropout_rng=jax.random.PRNGKey(0))
    jstate, jloss, _ = jax_make_train_step(jm)(jstate, jnp.asarray(x),
                                               jnp.asarray(t), jmask)
    state = TrainState(tm, make_optimizer(tm.parameters(), lr, 1e-2))
    loss, _ = make_train_step(state)(a["source"], torch.from_numpy(t).long(),
                                     mask)
    np.testing.assert_allclose(float(loss), float(jloss), atol=5e-4)
    # the step's grads, which stay in .grad after the update
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jflat[name.replace(".", "/")]),
                                   atol=5e-4, rtol=5e-4, err_msg=name)


def _ce(jm, params, x, t, mask):
    import optax

    logits = jm.apply({"params": params}, jnp.asarray(x), mask)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(t)).mean()


def test_split_table_reset_and_loc():
    t = SplitTable({"a": np.array([5, 6, 7]), "b": np.array(["x", "y", "z"],
                                                            object)},
                   np.array([10, 20, 30]))
    assert t.loc(20) == {"a": 6, "b": "y"}
    r = t.take([2, 0]).reset_index()
    assert r.index.tolist() == [0, 1] and r["index"].tolist() == [30, 10]
    assert t.take([2, 0]).reset_index(drop=True).columns.keys() == {"a", "b"}


@pytest.mark.parametrize("name", ["LIDC", "MRNet"])
def test_train_and_predict_clis_on_dataset_folders(name, tmp_path,
                                                   monkeypatch, lidc_root,
                                                   mrnet_root):
    """`train --dataset NAME --path_root DIR` through the CLI's builders on
    the tiny model for one epoch (MRNet's padding mask reaches every train
    and eval step), then `predict --save_saliency` on the run folder: the
    test split from the run's hparams, the NIfTIs' affine the spacing."""
    from mst_tpu_torch import predict
    from mst_tpu_torch.registry import get_model
    from mst_tpu_torch.train import cli, trainer as trainer_mod
    from mst_tpu_torch.utils.checkpoint import load_hparams

    root = lidc_root if name == "LIDC" else mrnet_root[0]
    masks = []

    def spy(model, source, mask=None, **kw):
        masks.append(mask)
        return mst_logits(model, source, mask, **kw)

    monkeypatch.setattr(trainer_mod, "mst_logits", spy)
    args = cli.parse_args(["--dataset", name, "--path_root", str(root),
                           "--dtype", "float32", "--max_epochs", "1",
                           "--batch_size", "2", "--num_train_samples", "2",
                           "--lr", "1e-3"])
    model = get_model(args.model, **TINY, **cli.model_kwargs(args))
    dm = cli.build_datamodule(args, "cpu")
    assert dm.ds_train.random_rotate and dm.ds_train.random_center
    run = tmp_path / name / "run"
    _, result = cli.train(args, model, dm, cli.build_trainer(args, dm,
                                                             run_dir=run))
    assert result.epochs_run == 1
    hp = load_hparams(run)
    assert hp["dataset"] == name and hp["fold"] == 0
    assert hp["path_root"] == str(root.resolve())
    if name == "MRNet":
        assert masks and all(m is not None and m.dtype == torch.bool
                             for m in masks)
    else:
        assert masks and all(m is None for m in masks)

    out = predict.main(["--run_folder", str(run), "--dtype", "float32",
                        "--save_saliency"], device="cpu")
    test = get_dataset(name, "test", path_root=root)
    with open(out / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["uid"] for r in rows] == [str(test[i]["uid"])
                                        for i in range(len(test))]
    sample = test[0]
    sal, aff = read_nifti(out / f"case_{sample['uid']}" / "saliency.nii.gz")
    inp, aff_in = read_nifti(out / f"case_{sample['uid']}" / "input.nii.gz")
    assert sal.shape == inp.shape == (224, 224, 32)
    want = np.asarray(sample["spacing_dhw"], np.float32)[::-1]
    np.testing.assert_array_equal(np.diag(aff)[:3].astype(np.float32), want)
    np.testing.assert_array_equal(aff, aff_in)
