"""The port's StyleGAN2 resampling ops against the JAX package, on the CPU:
``setup_filter``, the ``upfirdn2d`` family and ``conv2d_resample`` with its
fast paths.  Inputs come from numpy seeds; the port is NCHW, JAX NHWC.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.ops import conv_resample as jconv
from ic_gan_tpu.ops import resample as jres
from ic_gan_tpu_torch.ops import conv_resample as tconv
from ic_gan_tpu_torch.ops import resample as tres


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(x):
    return np.transpose(np.asarray(x, np.float32), (0, 2, 3, 1))


def _nchw_t(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


# --- upfirdn2d family and conv2d_resample ----------------------------------------

def _img(shape=(2, 3, 12, 10), seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


SYM, ASYM = [1, 3, 3, 1], [1, 2, 5, 1, 3]


@pytest.mark.parametrize("op,kw,taps", [
    ("upfirdn2d", dict(up=(2, 1), down=(1, 2), padding=(2, 1, 3, 0)), ASYM),
    ("upsample2d", dict(), SYM),
    ("downsample2d", dict(padding=-2, flip_filter=True), SYM),
    ("filter2d", dict(padding=1, gain=3.0), ASYM),
])
def test_upfirdn2d_family_matches_jax(op, kw, taps):
    """Separable and 2-D filters, symmetric and not, 1e-5."""
    x = _img()
    for separable in (True, False):
        fj = jres.setup_filter(jnp.asarray(taps, jnp.float32), separable=separable)
        ft = tres.setup_filter(taps, separable=separable)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
        ref = jax.jit(lambda a: getattr(jres, op)(a, fj, **kw))(jnp.asarray(_nhwc(x)))
        got = getattr(tres, op)(torch.from_numpy(x), ft, **kw)
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5,
                                   err_msg=f"separable={separable}")


@pytest.mark.parametrize("k,up,down,flip,pad", [
    (3, 2, 1, False, 1),   # the polyphase fast path (SynthesisLayer conv0)
    (3, 1, 2, True, 1),    # the composite strided fast path (D conv1)
    (1, 1, 2, True, 0),    # D's resnet skip
    (1, 2, 1, False, 0),   # the generic up path (G's resnet skip)
    (3, 1, 1, False, 1),   # plain, flipped kernel
    (3, 2, 1, True, 0),    # up, unpadded: generic
])
def test_conv2d_resample_matches_jax(k, up, down, flip, pad):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 6, 6).astype(np.float32)
    w = rng.randn(k, k, 4, 5).astype(np.float32)                    # HWIO
    fj = jres.setup_filter(jnp.asarray([1.0, 3.0, 3.0, 1.0]))
    ref = jconv.conv2d_resample(jnp.asarray(_nhwc(x)), jnp.asarray(w), f=fj, up=up, down=down,
                                padding=pad, flip_weight=flip)  # the fast paths read f's values
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    got = tconv.conv2d_resample(torch.from_numpy(x), wt, f=tres.setup_filter([1, 3, 3, 1]),
                                up=up, down=down, padding=pad, flip_weight=flip)
    assert got.shape == _nchw_t(np.asarray(ref)).shape
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kw,taps", [
    (dict(up=2, padding=(2, 1, 3, 0)), ASYM),
    (dict(up=(2, 1), down=(1, 2), padding=(1, 2, -1, 2), flip_filter=True, gain=3.0), SYM),
])
def test_upfirdn2d_gradients_match_jax_to_second_order(kw, taps):
    """The port's backward is upfirdn2d again (up and down swapped, padding
    complemented, filter flipped); JAX differentiates its banded products.
    d sum(sin(y))/dx and the gradient of its squared norm, 1e-5 and 1e-4 of
    max(1, max|JAX|)."""
    x = _img(seed=9)
    fj = jres.setup_filter(jnp.asarray(taps, jnp.float32))
    f = lambda a: jnp.sum(jnp.sin(jres.upfirdn2d(a, fj, **kw)))  # noqa: E731
    jg, jh = jax.jit(lambda a: (jax.grad(f)(a), jax.grad(
        lambda b: jnp.sum(jnp.square(jax.grad(f)(b))))(a)))(jnp.asarray(_nhwc(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tres.upfirdn2d(xt, tres.setup_filter(taps), **kw)
    (g,) = torch.autograd.grad(torch.sin(y).sum(), xt, create_graph=True)
    (h,) = torch.autograd.grad(g.square().sum(), xt)
    for got, ref, bar in ((_nhwc(g.detach()), np.asarray(jg), 1e-5), (_nhwc(h), np.asarray(jh), 1e-4)):
        assert np.abs(got - ref).max() <= bar * max(1.0, np.abs(ref).max())
