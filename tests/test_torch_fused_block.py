"""The port's fused sub-layers (`mst_tpu_torch.ops.fused_block`) on CPU
tensors against `mst_tpu`'s Pallas kernels (interpret mode on CPU) and
their XLA references, in f32 on the same numpy inputs.

On the CPU every wrapper takes its kernel's plain version, so these tests
pin the plain versions the CUDA kernels are checked against on the card
(`chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import fused_block as jfb
from mst_tpu_torch.ops import fused_block as tfb

N, S, E, HEADS, F = 2, 9, 32, 4, 64
TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_fused_block.py (f32)


def _inputs(seed, hidden, out_in):
    """x and (ln_s, ln_b, w_in [E, hidden], b_in, w_out [out_in, E], b_out,
    ls) as numpy f32; the LayerScale is O(1) so the branch matters."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, off=0.0):
        return (off + scale * rng.standard_normal(shape)).astype(np.float32)

    x = r(N, S, E)
    args = (r(E, scale=0.1, off=1.0), r(E, scale=0.1),
            r(E, hidden, scale=0.1), r(hidden, scale=0.1),
            r(out_in, E, scale=0.1), r(E, scale=0.1),
            r(E, scale=0.1, off=1.0))
    return x, args


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("with_ls", [False, True])
def test_attention_sublayer_matches_mst_tpu(with_ls, eps):
    x, args = _inputs(0, 3 * E, E)
    args = args[:-1] + (args[-1] if with_ls else None,)
    tfb.reset_launch_counts()
    out = tfb.fused_attention_sublayer(_torch(x), *map(_torch, args), HEADS,
                                       eps).numpy()
    kern = jfb.fused_attention_sublayer(_jax(x), *map(_jax, args), HEADS, eps)
    ref = jfb._attn_ref(_jax(x), *map(_jax, args), HEADS, eps)
    np.testing.assert_allclose(out, np.asarray(kern), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    assert set(tfb.launch_counts().values()) == {0}  # CPU: no kernel launch
    assert set(tfb.sublayer_calls().values()) == {0}


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("with_ls", [False, True])
def test_mlp_sublayer_matches_mst_tpu(with_ls, approximate, eps):
    x, args = _inputs(1, F, F)
    args = args[:-1] + (args[-1] if with_ls else None,)
    tfb.reset_launch_counts()
    out = tfb.fused_mlp_sublayer(_torch(x), *map(_torch, args), approximate,
                                 eps).numpy()
    kern = jfb.fused_mlp_sublayer(_jax(x), *map(_jax, args), approximate, eps)
    ref = jfb._mlp_ref(_jax(x), *map(_jax, args), approximate, eps)
    np.testing.assert_allclose(out, np.asarray(kern), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    assert set(tfb.launch_counts().values()) == {0}
    assert set(tfb.sublayer_calls().values()) == {0}


def test_mhsa_plain_version_is_a_row_softmax():
    """`_mhsa_ref` (exp2 with log2(e) folded in, normalised at the output)
    equals softmax(q k^T / sqrt(hd)) v per slice and head."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((N * S, 3 * E)).astype(
        np.float32))
    out = tfb.mhsa(qkv, N, S, HEADS)
    hd = E // HEADS
    t = qkv.reshape(N, S, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    p = torch.softmax(t[0] @ t[1].transpose(-1, -2) / hd ** 0.5, -1)
    ref = (p @ t[2]).permute(0, 2, 1, 3).reshape(N * S, E)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its kernel (CUDA) or its plain version (CPU) and
    nothing else."""
    x = torch.zeros(N, S, E, device="meta")
    _, args = _inputs(3, 3 * E, E)
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        tfb.fused_attention_sublayer(x, *map(_torch, args), HEADS)
