"""The port's predictor and server (`mst_tpu_torch.train.predictor`,
`mst_tpu_torch.serve`) on CPU at `tiny` size: TTA parity with `mst_tpu`'s
predict fn on the same weights, and the dynamic-batching HTTP server."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import unflatten_dict

from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
from mst_tpu_torch.serve import (
    BatchingPredictor,
    MODEL,
    build_server,
    load_weights,
    parse_args,
    serve_http,
)
from mst_tpu_torch.train.predictor import FLIP_SUBSETS, make_predict_fn

TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)


def _models(seed=0):
    tm = DinoSliceClassifier(out_ch=2, **TINY)
    flat = random_flax_params(tm, seed)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/gamma"):
            flat[k] = (1.0 + 0.1 * rng.standard_normal(flat[k].shape)
                       ).astype(np.float32)
    params_from_flax(tm, flat)
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})
    return tm, JaxMST(out_ch=2, use_flash=False, **TINY), jparams


@pytest.mark.parametrize("tta", [False, True])
def test_predict_fn_matches_mst_tpu(tta):
    tm, jm, jparams = _models()
    rng = np.random.default_rng(1)
    vols = rng.standard_normal((2, 1, 4, 28, 28)).astype(np.float32)
    mask = np.array([[False, False, True, True], [False] * 4])
    ref, _ = jax_make_predict_fn(jm, tta=tta, with_saliency=False)(
        jparams, jnp.asarray(vols), jnp.asarray(mask))
    probs, sal = make_predict_fn(tm, tta=tta, with_saliency=False)(
        vols, mask)
    assert sal is None and len(FLIP_SUBSETS) == 8
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), atol=1e-5)


def test_batching_server_answers_concurrent_posts():
    """6 concurrent POSTs on a batch-4 predictor: every row equals the direct
    predict row, a padded tail batch runs, /healthz counts them, malformed
    bodies are 400 and unknown paths 404."""
    tm, _, _ = _models(2)
    predict = make_predict_fn(tm, with_saliency=False)
    vols = np.random.default_rng(3).standard_normal(
        (6, 1, 2, 28, 28)).astype(np.float32)
    direct = predict(vols)[0].numpy()
    bp = BatchingPredictor(predict, batch_size=4, max_wait_ms=300)
    server = serve_http(bp, port=0, info={"model": "DinoV2ClassifierSlice"})
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results = [None] * len(vols)

    def post(i):
        buf = io.BytesIO()
        np.save(buf, vols[i])
        req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            results[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i in range(6):
            np.testing.assert_allclose(results[i]["probs"], direct[i],
                                       atol=1e-5)
            assert results[i]["pred"] == int(np.argmax(direct[i]))
        assert 2 <= bp.batches_run <= 3, bp.batches_run
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["volumes_served"] == 6
        assert health["model"] == "DinoV2ClassifierSlice"
        req = urllib.request.Request(f"{url}/predict", data=b"junk",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/nope", timeout=30)
        assert e.value.code == 404
        with pytest.raises(ValueError):
            bp.submit(vols[0, 0])  # not a [C, D, H, W] volume
    finally:
        server.shutdown()
        server.server_close()
        bp.close()
    with pytest.raises(RuntimeError):
        bp.submit(vols[0])


def test_device_fault_is_5xx_and_abandoned_requests_are_dropped():
    started, release = threading.Event(), threading.Event()

    def slow(src, mask):
        started.set()
        release.wait(10)
        return np.zeros((src.shape[0], 2), np.float32), None

    bp = BatchingPredictor(slow, batch_size=2, max_wait_ms=1)
    try:
        t1 = threading.Thread(target=lambda: bp.submit(
            np.zeros((1, 2, 4, 4), np.float32), timeout=30))
        t1.start()
        assert started.wait(10)
        with pytest.raises(TimeoutError):
            bp.submit(np.zeros((1, 2, 4, 4), np.float32), timeout=0.05)
        release.set()
        t1.join(timeout=10)
        assert not t1.is_alive()
        time.sleep(0.3)  # let the collector drain the abandoned entry
        assert bp.volumes_served == 1
    finally:
        release.set()
        bp.close()

    def boom(src, mask):
        raise RuntimeError("device fell over")

    bp = BatchingPredictor(boom, batch_size=1, max_wait_ms=1)
    server = serve_http(bp, port=0)
    try:
        buf = io.BytesIO()
        np.save(buf, np.zeros((1, 2, 4, 4), np.float32))
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
    finally:
        server.shutdown()
        server.server_close()
        bp.close()


def test_serve_cli_builds_a_cpu_server(tmp_path):
    """`python -m mst_tpu_torch.serve` flags: --params_npz loads a flat
    flax tree (here into a tiny CPU model the test builds itself; the CLI
    serves ViT-S on the card), later-slice flags are refused, and a run
    folder is one weight source among them (tests/test_torch_saliency.py
    serves one); --int8 serves the model's int8 copy."""
    tm, _, _ = _models(4)
    flat = {k.replace(".", "/"): v.detach().numpy()
            for k, v in tm.named_parameters()}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    args = parse_args(["--params_npz", str(npz), "--dtype", "float32",
                       "--port", "0", "--batch_size", "2"])
    model = load_weights(DinoSliceClassifier(out_ch=2, **TINY), args).eval()
    server, predictor = build_server(args, model)
    try:
        vol = np.random.default_rng(5).standard_normal(
            (1, 2, 28, 28)).astype(np.float32)
        got = predictor.submit(vol, timeout=60)
        want = make_predict_fn(tm, with_saliency=False)(
            vol[None])[0].numpy()[0]
        np.testing.assert_allclose(got, want, atol=1e-6)
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=30) as r:
            health = json.loads(r.read())
        assert health["model"] == MODEL and health["device"] == "cpu"
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()
    for flag in (["--exported", "x", "--run_folder", "y"],
                 ["--num_devices", "2"],
                 ["--run_folder", "x", "--params_npz", str(npz)]):
        with pytest.raises(SystemExit):
            parse_args(flag)
    # --int8 is ported: it parses, and the int8 copy of this model serves
    args8 = parse_args(["--params_npz", str(npz), "--dtype", "float32",
                        "--port", "0", "--batch_size", "2", "--int8"])
    assert args8.int8 and args8.int8_calib == 0
    model8 = quantize_mst_int8(model)
    server, predictor = build_server(args8, model8)
    try:
        got8 = predictor.submit(vol, timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        predictor.close()
    np.testing.assert_allclose(got8, make_predict_fn(
        model8, with_saliency=False)(vol[None])[0].numpy()[0], atol=1e-6)
    np.testing.assert_allclose(got8, want, atol=0.05)
