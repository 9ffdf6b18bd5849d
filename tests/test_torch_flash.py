"""Long-sequence serving and training in the port (slices above
`FUSED_MAX_TOKENS` = 512 tokens) on CPU tensors against `mst_tpu`, in f32
on the same numpy inputs:

- `ops.attention.flash_attention` (on the CPU the plain versions inside
  the same `autograd.Function` the flash kernels run in on the card)
  against JAX `flash_attention` in Pallas interpret mode, the whole-sequence
  kernels (`_fwd_single_kernel`, `_bwd_single_kernel`) and, with
  `SINGLE_BLOCK_MAX_KV` patched, the blocked ones (`_fwd_kernel`,
  `_bwd_dq_kernel`, `_bwd_dkv_kernel`): the output, the LSE and the grads
  of q, k and v through `jax.grad`;
- the composed path (`DinoSliceClassifier.forward`) against flax
  `JaxMST.apply` with `use_flash=True` on the same parameters: tiny ViT/14
  at 322 px (S = 530) with and without a key-padding mask, a tiny DINOv3
  (patch 16, 4 registers, RoPE) at 368 px (S = 534), the TTA predict fn,
  and two AdamW steps of `make_train_step` against the JAX
  `make_train_step` with and without remat, and frozen;
- routing by the slice size alone: S = 512 keeps the fused path bit for
  bit, S = 513 takes the composed path; the int8 refusals and the long
  saliency forward;
- `serve.build_server` answering a 322 px POST.

Tolerances: outputs 2e-5 (tests/test_attention.py), attention grads 1e-4,
logits 1e-4 (tests/test_torch_models.py), AdamW updates 5% of lr
(tests/test_torch_trainer.py). The CUDA kernels are held to these plain
versions on the card by `chip_smoke.py` (phases 34-36).
"""

import io
import json
import math
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import mst_tpu.ops.attention as JA
from mst_tpu.models.mst import DinoSliceClassifier as JaxMST
from mst_tpu.train.predictor import make_predict_fn as jax_make_predict_fn
from mst_tpu.train.trainer import TrainState as JaxTrainState
from mst_tpu.train.trainer import make_optimizer as jax_make_optimizer
from mst_tpu.train.trainer import make_train_step as jax_make_train_step
from mst_tpu_torch.models.convert import params_from_flax, random_flax_params
from mst_tpu_torch.models.mst import DinoSliceClassifier
from mst_tpu_torch.models.vit_fast import (
    FUSED_MAX_TOKENS,
    fused_mst_logits,
    fused_seq_len_ok,
    mst_logits,
)
from mst_tpu_torch.ops import attention as TA
from mst_tpu_torch.ops import fused_block as tfb
from mst_tpu_torch.ops.fused_int8 import quantize_mst_int8
from mst_tpu_torch.serve import build_server, parse_args
from mst_tpu_torch.train.predictor import make_predict_fn
from mst_tpu_torch.train.trainer import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

OUT_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_attention.py:29
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_models.py
TINY = dict(model_size="tiny", patch_size=14, fusion_heads=4)
TINY3 = dict(model_size="tiny", patch_size=16, num_register_tokens=4,
             use_rope_2d=True, rope_normalized=True, use_pos_embed=False,
             norm_eps=1e-5, fusion_heads=4)
PX, PX3 = 322, 368  # 23 x 23 patches: S = 530 (ViT/14), 534 (DINOv3/16)


def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _no_launches():
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch


def _flash_pair(q, k, v, w):
    """(port out, lse, grads; JAX out, natural-log lse, grads) of
    sum(o * w), the port's q, k, v as head views of one packed tensor."""
    b, h, s, d = q.shape
    packed = torch.from_numpy(np.stack([q, k, v], 0).transpose(1, 3, 0, 2, 4)
                              .copy()).requires_grad_(True)  # [B, S, 3, H, d]
    tq, tk, tv = (u.transpose(1, 2) for u in packed.unbind(2))
    tfb.reset_launch_counts()
    out = TA.flash_attention(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    _no_launches()
    grads = [packed.grad[:, :, i].transpose(1, 2) for i in range(3)]
    with torch.no_grad():
        _, lse = TA.flash_fwd(tq, tk, tv, want_lse=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = JA.flash_attention(jq, jk, jv, interpret=True)
    _, jlse = JA._flash_fwd(jq, jk, jv, 1.0 / math.sqrt(d), 128, 128, True)
    jgrads = jax.grad(lambda a, b_, c: jnp.sum(
        JA.flash_attention(a, b_, c, interpret=True) * jnp.asarray(w)),
        argnums=(0, 1, 2))(jq, jk, jv)
    return (out.detach(), lse, grads), (jout, jlse, jgrads)


@pytest.mark.parametrize("s", [16, 77, 530])
def test_flash_attention_matches_jax_whole_sequence_kernels(s):
    """Out, LSE (base 2 in the port, natural log in JAX) and the grads of
    q, k, v against the Pallas whole-sequence forward and backward."""
    q, k, v = _qkv(s, 1, 2, s, 16)
    w = np.random.default_rng(s + 1).standard_normal(q.shape).astype(
        np.float32)
    (out, lse, grads), (jout, jlse, jgrads) = _flash_pair(q, k, v, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy() / TA.LOG2E, np.asarray(jlse),
                               **OUT_TOL)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_attention_matches_jax_blocked_kernels(monkeypatch):
    """The blocked Pallas path (`_fwd_kernel`, `_bwd_dq_kernel`,
    `_bwd_dkv_kernel`, with `_pad_to` copies), forced at S = 200 as
    tests/test_attention.py:46 forces it: the port's one kernel pair has
    no such split, and matches both paths."""
    monkeypatch.setattr(JA, "SINGLE_BLOCK_MAX_KV", 64)
    q, k, v = _qkv(3, 2, 2, 200, 16)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    (out, lse, grads), (jout, jlse, jgrads) = _flash_pair(q, k, v, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy() / TA.LOG2E, np.asarray(jlse),
                               **OUT_TOL)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_backward_formulas_match_autograd_in_f64():
    """The explicit backward (`_flash_bwd_dq_ref`, `_flash_bwd_dkv_ref`, the
    plain versions of the dq and dk/dv kernels) equals autograd of the plain
    softmax attention, and f64 stays f64 (the oracle)."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True)
               for a in _qkv(5, 2, 3, 41, 16))
    g = torch.from_numpy(_qkv(6, 2, 3, 41, 16)[0]).double()
    out = TA.flash_attention(q, k, v, sm_scale=0.3)
    assert out.dtype == torch.float64
    ours = torch.autograd.grad(out, (q, k, v), g)
    ref_out = torch.softmax(q @ k.transpose(-1, -2) * 0.3, -1) @ v
    ref = torch.autograd.grad(ref_out, (q, k, v), g)
    torch.testing.assert_close(out, ref_out, atol=1e-12, rtol=1e-12)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def test_flash_takes_head_views_of_a_packed_qkv():
    """A contiguous q, k, v and the head views of a packed qkv (what the
    composed `Attention` hands over, with no copy) give the same bits."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 3, 33, 16))
    packed = torch.stack([q, k, v], 2).transpose(1, 3).contiguous()
    views = [u.transpose(1, 2) for u in packed.unbind(2)]
    assert not views[0].is_contiguous()
    assert torch.equal(TA.flash_fwd(q, k, v), TA.flash_fwd(*views))


# -- the slice: the composed path vs flax ------------------------------------


def _pair(kw, seed, shape):
    """(port model, flax model with the flash path, flax params, volume):
    seeded weights with O(1) LayerScale, so every block counts."""
    tm = DinoSliceClassifier(out_ch=2, **kw)
    flat = random_flax_params(tm, seed)
    rng = np.random.default_rng(seed)
    for key in flat:
        if key.endswith("/gamma"):
            flat[key] = (1.0 + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    params_from_flax(tm, flat)
    jm = JaxMST(out_ch=2, use_flash=True, **kw)
    vol = rng.standard_normal(shape).astype(np.float32)
    return tm, jm, flat, vol


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.mark.parametrize("kw,px,masked", [(TINY, PX, False),
                                          (TINY, PX, True),
                                          (TINY3, PX3, False)],
                         ids=["v2", "v2-mask", "v3-rope"])
def test_composed_logits_match_flax_flash_path(kw, px, masked):
    tm, jm, flat, vol = _pair(kw, 0, (2, 1, 3, px, px))
    assert not fused_seq_len_ok(tm, px, px)
    mask = np.array([[False, False, True], [False] * 3]) if masked else None
    tfb.reset_launch_counts()
    with torch.no_grad():
        logits = mst_logits(tm, torch.from_numpy(vol),
                            None if mask is None else torch.from_numpy(mask))
    _no_launches()
    ref = jm.apply({"params": _tree(flat)}, jnp.asarray(vol),
                   None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_predict_fn_with_tta_matches_jax_at_530_tokens():
    tm, jm, flat, vol = _pair(TINY, 1, (1, 1, 2, PX, PX))
    ref, _ = jax_make_predict_fn(jm, tta=True, with_saliency=False)(
        _tree(flat), jnp.asarray(vol), None)
    probs, sal = make_predict_fn(tm, tta=True, with_saliency=False)(vol)
    assert sal is None
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "remat", "freeze"])
def test_adamw_steps_match_jax_make_train_step_at_530_tokens(mode):
    """Two AdamW steps of the port's train step on the composed path
    against the JAX `make_train_step` (on the CPU the flax path with
    `flash_attention`'s custom VJP): every parameter moves as the JAX one
    does, to 5% of lr; `remat` on both sides; a frozen encoder stays bit
    for bit where it was. The key thirds of the packed qkv biases (zero
    grad in exact arithmetic) and weights whose first grad is below 1e-6 of
    the tensor's largest are Adam steps of rounding noise, bounded by 2 lr
    (tests/test_torch_unfrozen.py)."""
    lr, wd = 1e-3, 1e-2
    kw = dict(TINY, remat=mode == "remat", freeze=mode == "freeze")
    shape = (2, 1, 2, PX, PX)
    tm, jm, flat, x = _pair(kw, 2, shape)
    t = np.array([0, 1])
    x2 = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    torch.nn.functional.cross_entropy(
        tm(torch.from_numpy(x), train=True), torch.from_numpy(t)).backward()
    noise = {n: ((p.grad != 0) & (p.grad.abs() < 1e-6 * p.grad.abs().max())
                 ).numpy() for n, p in tm.named_parameters()
             if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=_tree(flat),
        tx=jax_make_optimizer(lr, wd, freeze_encoder=mode == "freeze"),
        dropout_rng=jax.random.PRNGKey(0))
    jstep = jax_make_train_step(jm)
    step = make_train_step(TrainState(tm, make_optimizer(tm.parameters(),
                                                         lr, wd)))
    tfb.reset_launch_counts()
    for xb in (x, x2):
        jstate, jloss, _ = jstep(jstate, jnp.asarray(xb), jnp.asarray(t), None)
        loss, _ = step(torch.from_numpy(xb), torch.from_numpy(t))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    _no_launches()
    jflat = flatten_dict(jstate.params, sep="/")
    for name, p in tm.named_parameters():
        key = name.replace(".", "/")
        ours = p.detach().numpy() - flat[key]
        if mode == "freeze" and name.startswith("encoder."):
            assert p.grad is None, name
            np.testing.assert_array_equal(ours, 0.0, err_msg=name)
            np.testing.assert_array_equal(np.asarray(jflat[key]), flat[key],
                                          err_msg=name)
            continue
        ref = np.asarray(jflat[key]) - flat[key]
        adam_only = noise[name].copy()
        if key.endswith(("attn/qkv/bias", "self_attn/in_proj/bias")):
            e = ours.shape[0] // 3  # [q | k | v]
            adam_only[e:2 * e] = True
        assert np.abs(ours[adam_only]).max(initial=0) <= 2 * lr * (
            1.0 + 1e-3), name
        ours, ref = ours[~adam_only], ref[~adam_only]
        assert np.abs(ours).max() > 0.1 * lr, name  # it did train
        np.testing.assert_allclose(ours, ref, atol=0.05 * lr, rtol=0,
                                   err_msg=name)


# -- routing ---------------------------------------------------------------


def test_routing_by_slice_tokens_alone():
    """S = 1 + 7 x 73 = 512 stays on the fused path, bit for bit (the
    serving, eval and train forwards); S = 1 + 16 x 32 = 513 takes the
    composed path, which the fused forward refuses."""
    tm, _, _, _ = _pair(TINY, 4, (1, 1, 1, 14, 14))
    rng = np.random.default_rng(5)
    at_512 = torch.from_numpy(rng.standard_normal((1, 1, 2, 98, 1022))
                              .astype(np.float32))
    at_513 = torch.from_numpy(rng.standard_normal((1, 1, 2, 224, 448))
                              .astype(np.float32))
    assert 1 + 7 * 73 == FUSED_MAX_TOKENS
    with torch.no_grad():
        fused = fused_mst_logits(tm, at_512)
        assert torch.equal(mst_logits(tm, at_512), fused)
        assert torch.equal(make_eval_step(tm)(at_512), fused)
        assert torch.equal(mst_logits(tm, at_512, train=True), fused)
        assert torch.equal(mst_logits(tm, at_513), tm(at_513))
        assert torch.equal(make_eval_step(tm)(at_513), tm(at_513))
        with pytest.raises(NotImplementedError, match="composed path"):
            fused_mst_logits(tm, at_513)


def test_int8_and_saliency_refuse_long_slices():
    """Above 512 tokens an int8 model raises JAX's ValueError (int8 needs the
    fused path), with or without saliency; saliency of a bf16/f32 model
    runs on the composed path (tests/test_torch_long_saliency.py holds it
    to JAX). Both serve at 224 px."""
    tm, _, _, _ = _pair(TINY, 6, (1, 1, 1, 14, 14))
    tq = quantize_mst_int8(tm)
    big = np.zeros((1, 1, 2, PX, PX), np.float32)
    for with_saliency in (False, True):
        with pytest.raises(ValueError, match="int8"):
            make_predict_fn(tq, with_saliency=with_saliency)(big)
    probs, sal = make_predict_fn(tm, with_saliency=True)(big)
    assert probs.shape == (1, 2) and sal.shape == (1, 2, PX, PX)
    small = np.zeros((1, 1, 2, 28, 28), np.float32)
    for model in (tm, tq):
        probs, sal = make_predict_fn(model)(small)
        assert probs.shape == (1, 2) and sal.shape == (1, 2, 28, 28)


def test_server_answers_a_322_px_post():
    """`serve.build_server` on a tiny CPU model answers a [1, 2, 322, 322]
    POST on the composed path (the direct probs); an int8 model answers it
    with HTTP 400."""
    tm, _, _, vol = _pair(TINY, 7, (1, 1, 2, PX, PX))
    args = parse_args(["--port", "0", "--batch_size", "2", "--max_wait_ms",
                       "1", "--dtype", "float32"])
    direct = make_predict_fn(tm, with_saliency=False)(vol)[0][0].numpy()
    buf = io.BytesIO()
    np.save(buf, vol[0])
    for model, code in ((tm, 200), (quantize_mst_int8(tm), 400)):
        server, bp = build_server(args, model)
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        try:
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    status, body = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                status, body = e.code, json.loads(e.read())
        finally:
            server.shutdown()
            server.server_close()
            bp.close()
        assert status == code, body
        if code == 200:
            np.testing.assert_allclose(body["probs"], direct, atol=1e-6)
            assert body["pred"] == int(np.argmax(direct))
        else:
            assert "ValueError" in body["error"] and "int8" in body["error"]
