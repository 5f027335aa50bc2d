"""The port's ops (``ic_gan_tpu_torch.ops``) against their JAX counterparts.

Inputs come from numpy seeds and go through both packages on the CPU.  The
JAX attention runs through ``_attention_xla`` and through the Pallas kernel
in interpret mode, as ``tests/test_pallas_attention.py`` runs it; the port's
attention wrapper takes its plain version on CPU tensors.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ic_gan_tpu.ops import resample as jresample
from ic_gan_tpu.ops import spectral_norm as jsn
from ic_gan_tpu.ops.pallas import attention as jattn
from ic_gan_tpu_torch.ops import attention as tattn
from ic_gan_tpu_torch.ops import resample as tresample
from ic_gan_tpu_torch.ops import spectral_norm as tsn


def _nhwc(x):
    return np.transpose(np.asarray(x, np.float32), (0, 2, 3, 1))


def _hwio_to_oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


# --- (a) spectral norm -------------------------------------------------------

@pytest.mark.parametrize("shape,num_svs", [
    ((24, 16), 1),        # dense (in, out)
    ((3, 3, 8, 16), 1),   # conv HWIO
    ((1, 1, 32, 12), 2),  # 1×1 conv, two singular vectors (Gram-Schmidt)
])
def test_spectral_norm_sigma_matches_jax(shape, num_svs):
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32)
    u = rng.randn(num_svs, shape[-1]).astype(np.float32)
    jw_bar, ju, jsvs = jsn.spectral_normalize(jnp.asarray(w), jnp.asarray(u),
                                              update=True)
    w_t = w.T if w.ndim == 2 else _hwio_to_oihw(w)
    tw_bar, tu, tsvs = tsn.spectral_normalize(torch.from_numpy(w_t),
                                              torch.from_numpy(u), update=True)
    np.testing.assert_allclose(tsvs.numpy(), np.asarray(jsvs), rtol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-7)
    jw_bar = np.asarray(jw_bar)
    jw_t = jw_bar.T if w.ndim == 2 else _hwio_to_oihw(jw_bar)
    np.testing.assert_allclose(tw_bar.numpy(), jw_t, rtol=1e-6, atol=1e-7)
    # Eval (update=False) returns the state it was given.
    _, tu_eval, _ = tsn.spectral_normalize(torch.from_numpy(w_t),
                                           torch.from_numpy(u), update=False)
    np.testing.assert_array_equal(tu_eval.numpy(), u)


# --- (b) polyphase upsample-conv ----------------------------------------------

@pytest.mark.parametrize("hw", [(5, 6), (8, 8)])
def test_conv3x3_nearest_up_matches_jax_and_interpolate(hw):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, *hw).astype(np.float32)       # NCHW
    w = rng.randn(3, 3, 4, 6).astype(np.float32)      # HWIO
    b = rng.randn(6).astype(np.float32)
    ref_j = np.asarray(jresample.conv3x3_nearest_up(
        jnp.asarray(_nhwc(x)), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(_hwio_to_oihw(w))
    got = tresample.conv3x3_nearest_up(xt, wt)
    np.testing.assert_allclose(_nhwc(got.numpy()), ref_j, atol=1e-5)
    naive = F.conv2d(F.interpolate(xt, scale_factor=2, mode="nearest"), wt,
                     torch.from_numpy(b), padding=1)
    got_b = tresample.conv3x3_nearest_up(xt, wt, torch.from_numpy(b))
    np.testing.assert_allclose(got_b.numpy(), naive.numpy(), atol=1e-5)


def test_upsample_nearest_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
    ref = np.asarray(jresample.upsample_nearest_2x(jnp.asarray(_nhwc(x))))
    got = tresample.upsample_nearest_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(_nhwc(got.numpy()), ref)


def test_conv3x3_nearest_up_rejects_other_kernels():
    with pytest.raises(ValueError):
        tresample.conv3x3_nearest_up(torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1))


# --- (c) max pool ---------------------------------------------------------------

def test_max_pool_matches_jax_exactly():
    x = np.random.RandomState(3).randn(2, 5, 8, 6).astype(np.float32)
    ref = np.asarray(jresample.max_pool_2x(jnp.asarray(_nhwc(x))))
    got = tresample.max_pool_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(_nhwc(got.numpy()), ref)


# --- (d) attention plain version --------------------------------------------

def _attn_inputs(shape=(2, 256, 128, 8, 16), seed=4):
    n, lq, lk, d, dv = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(n, lq, d).astype(np.float32),
            rng.randn(n, lk, d).astype(np.float32),
            rng.randn(n, lk, dv).astype(np.float32))


_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_jax(dtype, oracle):
    arrays = _attn_inputs()
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    if oracle == "xla":
        ref = jattn._attention_xla(*jargs)
    else:
        ref = jattn.sagan_attention(*jargs, True)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = tattn.sagan_attention_ref(*targs)
    assert got.dtype == targs[2].dtype and got.shape == (2, 256, 16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=_TOL[dtype])


# --- (e) attention wrapper on CPU tensors -------------------------------------

def test_attention_wrapper_takes_plain_path_on_cpu():
    targs = [torch.from_numpy(a) for a in _attn_inputs((2, 100, 25, 6, 10))]
    before = tattn.sagan_attention_fwd.launches
    got = tattn.sagan_attention(*targs)
    assert tattn.sagan_attention_fwd.launches == before
    torch.testing.assert_close(got, tattn.sagan_attention_ref(*targs), rtol=0, atol=0)


def test_attention_wrapper_refuses_other_devices():
    # A tensor off the CPU never takes the plain version.
    meta = [torch.empty(2, 16, 8, device="meta"), torch.empty(2, 4, 8, device="meta"),
            torch.empty(2, 4, 8, device="meta")]
    with pytest.raises(ValueError):
        tattn.sagan_attention(*meta)
    with pytest.raises(ValueError):
        tattn.sagan_attention(torch.zeros(2, 16, 8), *meta[1:])
