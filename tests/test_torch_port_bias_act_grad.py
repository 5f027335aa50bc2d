"""``BiasActGrad``, the backward of the port's bias-activation (kernel B4's
backward pass), against the JAX package on the CPU.

On CPU tensors ``BiasActGrad`` runs its plain version; these tests hold that
version, and the derivatives the Function gives of it, to JAX's own
differentiation of ``ic_gan_tpu.ops.bias_act.bias_act``: the first order
against ``jax.vjp``, the second order (the Function's backward, with the
``act″`` column of the activation table) against the gradient of
⟨vjp, v⟩, then ``gradgradcheck`` in float64 and linearity in ``gy``.  Each
activation compiles one JAX function.  Inputs come from numpy seeds; the
layout is NCHW on both sides (JAX's ``bias_act`` takes ``axis=1``).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu_torch.ops import bias_act as tba
from test_torch_port_classcond import cheap_jit

# The module, not the function that ``ic_gan_tpu.ops`` exports under its name.
jba = importlib.import_module("ic_gan_tpu.ops.bias_act")

ACTS = list(jba.activation_funcs)
SHAPE = (2, 8, 4, 4)
CLAMP = 0.8   # below the largest outputs of every activation, so the mask cuts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(act):
    """x, b, gy and v (the second order's direction), f32.  gy and v lie in
    [-1, 1], so the gradients stay under 2, where two roundings in another
    order differ by under 1e-6."""
    rng = np.random.RandomState(100 + ACTS.index(act))
    x = rng.randn(*SHAPE).astype(np.float32)
    b = rng.randn(SHAPE[1]).astype(np.float32)
    gy, v = (rng.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(2))
    return x, b, gy, v


@functools.lru_cache(maxsize=None)
def _jax_side(act):
    """JAX's (gx, gb) = vjp of ``bias_act`` at (x, b) applied to gy, and the
    gradient of Σ gx·v in (gy, x, b): one jitted function per activation."""

    def vjp(x, b, gy):
        _, pull = jax.vjp(lambda x_, b_: jba.bias_act(x_, b_, axis=1, act=act, clamp=CLAMP),
                          x, b)
        return pull(gy)

    def inner(gy, x, b, v):
        return jnp.sum(vjp(x, b, gy)[0] * v)

    fn = cheap_jit(lambda x, b, gy, v: vjp(x, b, gy) + jax.grad(inner, argnums=(0, 1, 2))(
        gy, x, b, v))
    return tuple(np.asarray(t) for t in fn(*(jnp.asarray(a) for a in _inputs(act))))


def _grad(gy, x, b, act, clamp=CLAMP):
    return tba.BiasActGrad.apply(gy, x, b, 1, act, None, None, clamp)


@pytest.mark.parametrize("act", ACTS)
def test_grad_matches_jax_vjp(act):
    """``BiasActGrad`` (gx), and ``bias_act``'s backward (gx and the bias sum
    gb), against ``jax.vjp``, with a bias and a clamp that cuts; f32, atol
    1e-6."""
    x, b, gy, _ = (torch.from_numpy(a) for a in _inputs(act))
    jgx, jgb = _jax_side(act)[:2]
    np.testing.assert_allclose(_grad(gy, x, b, act).numpy(), jgx, atol=1e-6)
    xx, bb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    gx, gb = torch.autograd.grad(tba.bias_act(xx, bb, 1, act, clamp=CLAMP), (xx, bb), gy)
    np.testing.assert_allclose(gx.numpy(), jgx, atol=1e-6)
    # gb sums 32 elements of up to ~2: a few f32 ulps of 64.
    np.testing.assert_allclose(gb.numpy(), jgb, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_grad_backward_matches_jax_second_order(act):
    """The gradient of Σ BiasActGrad(gy, x, b)·v in gy, x and b (the
    Function's backward: the same Function on the incoming gradient, and
    ``act″`` in x and b) against JAX's second order; rtol 1e-5, with atol
    1e-6 for the entries near zero (f32 rounding of values under 2).  For
    linear, relu and lrelu the x and b parts are exactly zero on both
    sides."""
    x, b, gy, v = (torch.from_numpy(a) for a in _inputs(act))
    gy, x, b = (t.clone().requires_grad_(True) for t in (gy, x, b))
    got = torch.autograd.grad((_grad(gy, x, b, act) * v).sum(), (gy, x, b),
                              allow_unused=True, materialize_grads=True)
    for name, t, ref in zip(("gy", "x", "b"), got, _jax_side(act)[2:]):
        if tba.activation_funcs[act].grad2 is None and name != "gy":
            assert not t.any() and not ref.any(), name
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=name)


def _away_from_kinks(act, seed):
    """float64 (gy, x, b) at (2, 4, 3, 3) with every x + b at least 0.1 from
    0 (the kinks of relu and lrelu) and every |gain·act(x + b)| at least 0.05
    from the clamp's edge, so finite differences of step 1e-6 see smooth
    functions."""
    rng = np.random.RandomState(seed)
    gain = tba.activation_funcs[act].def_gain
    clamp = 1.0
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, 4))
    x = torch.from_numpy(rng.randn(2, 4, 3, 3) * 1.5)
    while True:
        v = x + b[:, None, None]
        y = (gain * tba.bias_act_ref(v, None, 1, act, None, 1.0)).abs()
        bad = (v.abs() < 0.1) | ((y - clamp).abs() < 0.05)
        if not bad.any():
            break
        x = torch.where(bad, torch.from_numpy(rng.randn(2, 4, 3, 3) * 1.5), x)
    gy = torch.from_numpy(rng.randn(2, 4, 3, 3))
    return gy, x, b, clamp


@pytest.mark.parametrize("act", ACTS)
def test_grad_gradgradcheck_float64(act):
    """``torch.autograd.gradcheck`` and ``gradgradcheck`` of BiasActGrad in
    (gy, x, b), float64, with a clamp that cuts some elements."""
    gy, x, b, clamp = _away_from_kinks(act, 200 + ACTS.index(act))
    inputs = tuple(t.requires_grad_(True) for t in (gy, x, b))

    def fn(gy_, x_, b_):
        return _grad(gy_, x_, b_, act, clamp)

    assert torch.autograd.gradcheck(fn, inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


@pytest.mark.parametrize("act", ACTS)
def test_grad_is_linear_in_gy(act):
    """BiasActGrad(a·g1 + c·g2) = a·BiasActGrad(g1) + c·BiasActGrad(g2),
    float64 to 1e-12; a power-of-two scale is exact."""
    gy, x, b, clamp = _away_from_kinks(act, 300 + ACTS.index(act))
    g2 = torch.from_numpy(np.random.RandomState(400 + ACTS.index(act)).randn(*gy.shape))
    lhs = _grad(0.75 * gy - 2.5 * g2, x, b, act, clamp)
    rhs = 0.75 * _grad(gy, x, b, act, clamp) - 2.5 * _grad(g2, x, b, act, clamp)
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)
    assert torch.equal(_grad(4.0 * gy, x, b, act, clamp), 4.0 * _grad(gy, x, b, act, clamp))
