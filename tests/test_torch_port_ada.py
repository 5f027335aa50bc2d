"""The port's ADA pipe and its gather-free warp against the JAX package, on
the CPU.

``affine_warp`` against JAX's with ``use_pallas=True`` (the Pallas row shift
in interpret mode); ``AugmentPipe`` with the fast and the exact geometry,
pinned by ``debug_percentile`` (the reference's deterministic hook, which
both pipes have), and at p 0, where every gate is closed so no draw matters;
``grid_sample_bilinear``.  Inputs come from numpy seeds; the port is NCHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.special
import scipy.ndimage
import scipy.special

from ic_gan_tpu.data import ada as jada
from ic_gan_tpu.data import fast_warp as jwarp
from ic_gan_tpu_torch.data import ada as tada
from ic_gan_tpu_torch.data import fast_warp as twarp
from ic_gan_tpu_torch.ops import row_shift as trs
from test_torch_port_classcond import cheap_jit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _smooth(shape, seed):
    """Band-limited images (N, H, W, C), as ADA's 2× wavelet upsample makes."""
    x = np.random.RandomState(seed).randn(*shape)
    return scipy.ndimage.gaussian_filter(x, (0, 1.5, 1.5, 0)).astype(np.float32) * 2


def _affine(theta, sx, sy, tx, ty):
    A = np.array([[sx * np.cos(theta), -sx * np.sin(theta)],
                  [sy * np.sin(theta), sy * np.cos(theta)]], np.float32)
    return A, np.array([tx, ty], np.float32)


def test_affine_warp_matches_jax_pallas_path():
    """Per-sample affines: a translation, a rotation with scale, and one near
    90° that takes the axis swap; 1e-5 (the same arithmetic in both)."""
    img = _smooth((3, 24, 24, 3), 0)
    params = [(0.0, 1.0, 1.0, 2.5, -3.25), (0.7, 1.2, 0.9, 3, -2), (np.pi / 2 - 0.1, 1, 1, 20, 5)]
    A, t = (np.stack(v) for v in zip(*(_affine(*p) for p in params)))
    assert abs(A[2, 0, 0]) < abs(A[2, 1, 0])  # the third sample swaps axes
    ref = cheap_jit(lambda *a: jwarp.affine_warp(*a, use_pallas=True))(
        jnp.asarray(img), jnp.asarray(A), jnp.asarray(t))
    got = twarp.affine_warp(torch.from_numpy(np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))),
                            torch.from_numpy(A), torch.from_numpy(t))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def bgc_fast():
    """The JAX 'bgc' pipe on the fast geometry at debug_percentile 0.3 (the
    training path: a 90° rotation, a translation, scalings, a rotation,
    colour), its output and the gradient of sum(sin(output)), from one jit.
    The pipe reads ``float(erfinv(dp·2 − 1))`` of its percentile, which a
    trace cannot give; scipy's ``erfinv`` stands in for JAX's meanwhile (the
    port's pipe uses scipy's too), so the whole pipe compiles as one program
    instead of some 200 eagerly compiled constant ops."""
    x = _smooth((2, 24, 24, 3), 1)
    jpipe = jada.AugmentPipe.from_spec("bgc", geom_impl="fast")

    def run(a):
        out, vjp = jax.vjp(lambda b: jpipe(jax.random.PRNGKey(0), b, 0.5,
                                           debug_percentile=0.3), a)
        return out, vjp(jnp.cos(out))[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.scipy.special, "erfinv", scipy.special.erfinv)
        out, grad = cheap_jit(run)(jnp.asarray(x))
    return x, np.asarray(out), np.asarray(grad)


def _port_pipe(x, impl, dp, p=0.5, grad=False):
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    xt.requires_grad_(grad)
    out = tada.AugmentPipe.from_spec("bgc", geom_impl=impl)(
        xt, p, torch.Generator().manual_seed(0), debug_percentile=dp)
    return xt, out


def test_augment_pipe_matches_jax_under_debug_percentile(bgc_fast):
    """1e-4: the same arithmetic, float32 through a dozen resampling and
    colour steps."""
    x, ref, _ = bgc_fast
    _, got = _port_pipe(x, "fast", 0.3)
    assert got.shape == (2, 3, 24, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-4)


def test_augment_pipe_gradient_matches_jax(bgc_fast):
    """The D gradient flows back through the fast pipe (B3's adjoint on the
    card): d sum(sin(pipe(x))) / dx against JAX's, 1e-4."""
    x, _, ref = bgc_fast
    before = trs.row_shift_fwd.launches
    xt, out = _port_pipe(x, "fast", 0.3, grad=True)
    (g,) = torch.autograd.grad(torch.sin(out).sum(), xt)
    assert trs.row_shift_fwd.launches == before   # the CPU takes the plain version
    np.testing.assert_allclose(_nhwc(g), ref, atol=1e-4)


def test_augment_pipe_at_p0_exact_geometry_matches_jax():
    """p 0 closes every gate, so no draw matters: the two pipes must agree
    with the draws left random, here on the exact (bilinear) geometry; the
    geometric stage still resamples (the wavelet up/down pair is near, not
    exactly, the identity)."""
    x = _smooth((2, 24, 24, 3), 2)
    jpipe = jada.AugmentPipe.from_spec("bgc", geom_impl="exact")
    ref = cheap_jit(lambda a: jpipe(jax.random.PRNGKey(3), a, 0.0))(jnp.asarray(x))
    _, got = _port_pipe(x, "exact", None, p=torch.tensor(0.0))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-4)
    assert 0 < np.abs(_nhwc(got) - x).max() < 0.1


def test_grid_sample_bilinear_matches_jax():
    rng = np.random.RandomState(6)
    img = rng.randn(2, 9, 7, 3).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    ref = jada.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))
    got = tada.grid_sample_bilinear(
        torch.from_numpy(np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))),
        torch.from_numpy(grid))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)


def test_matrix_helpers_and_fbank_match_jax():
    theta = np.array([0.3, -1.2], np.float32)
    s = np.array([1.3, 0.7], np.float32)
    tt = torch.from_numpy
    for jf, tf, args in ((jada.rotate2d_inv, tada.rotate2d_inv, (theta,)),
                         (jada.scale2d, tada.scale2d, (s, s[::-1].copy())),
                         (jada.translate2d_inv, tada.translate2d_inv, (theta, s)),
                         (jada.scale3d, tada.scale3d, (s, s, theta)),
                         (jada.translate3d, tada.translate3d, (s, theta, s))):
        np.testing.assert_allclose(tf(*map(tt, args)).numpy(),
                                   np.asarray(jf(*map(jnp.asarray, args))), atol=1e-6)
    v = np.ones(3, np.float32) / np.sqrt(3)
    np.testing.assert_allclose(tada.rotate3d(v, tt(theta)).numpy(),
                               np.asarray(jada.rotate3d(jnp.asarray(v), jnp.asarray(theta))),
                               atol=1e-6)
    np.testing.assert_array_equal(tada._build_fbank(), jada._build_fbank())
    np.testing.assert_allclose(tada.AugmentPipe().Hz_geom.numpy(),
                               np.asarray(jada.AugmentPipe().Hz_geom), rtol=1e-6)
