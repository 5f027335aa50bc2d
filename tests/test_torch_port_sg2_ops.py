"""The port's StyleGAN2 ops against the JAX package, on the CPU.

``bias_act`` (kernel B4's plain version, and the autograd Function that runs
it on CPU tensors) against JAX ``bias_act`` and ``bias_act_fused``, whose
Pallas kernel runs in interpret mode here; ``row_shift`` (kernel B3's) against
JAX ``row_shift(..., interpret=True)``, as ``tests/test_row_shift.py`` runs it.
(The resampling ops are in ``test_torch_port_sg2_resample.py``.)  Inputs
come from numpy seeds; the port is NCHW, JAX NHWC.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.data import fast_warp as jwarp
from ic_gan_tpu.ops.pallas import bias_act as jpba
from ic_gan_tpu.ops.pallas import row_shift as jrs
from ic_gan_tpu_torch.ops import bias_act as tba
from ic_gan_tpu_torch.ops import row_shift as trs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The module, not the function that ``ic_gan_tpu.ops`` exports under its name.
jba = importlib.import_module("ic_gan_tpu.ops.bias_act")


def _nhwc(x):
    return np.transpose(np.asarray(x, np.float32), (0, 2, 3, 1))


# --- (a) bias_act (B4) -----------------------------------------------------------

ACTS = list(jba.activation_funcs)


def test_activation_table_matches_jax():
    assert list(tba.activation_funcs) == ACTS
    for name, spec in jba.activation_funcs.items():
        assert tba.activation_funcs[name].def_gain == spec.def_gain, name


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_jax_to_second_order(act):
    """Forward (plain version and Function, bias or none, clamp or none)
    against JAX ``bias_act``, and with a bias against the Pallas
    ``bias_act_fused`` in interpret mode (one interpreter compile per
    activation), atol 1e-6 (the bar of tests/test_pallas_bias_act.py); gradients of
    sum(y²) in x and b, 1e-5; the gradient of the gradient's squared norm,
    1e-4 (both relative to the gradient's size, ``_close_scaled``)."""
    rng = np.random.RandomState(ACTS.index(act))
    x = rng.randn(2, 128, 4, 4).astype(np.float32)      # NCHW; NHWC rows 32, C 128
    b = rng.randn(128).astype(np.float32)
    xj, bj, xt, bt = jnp.asarray(_nhwc(x)), jnp.asarray(b), torch.from_numpy(x), torch.from_numpy(b)
    fused = np.asarray(jax.jit(lambda a, b: jpba.bias_act_fused(a, b, act, None, None))(xj, bj))
    np.testing.assert_allclose(_nhwc(tba.bias_act(xt, bt, act=act)), fused, atol=1e-6)
    for bias, clamp in ((True, None), (False, None), (True, 1.0)):
        jb, tb = (bj, bt) if bias else (None, None)
        ref = np.asarray(jax.jit(lambda a, b: jba.bias_act(a, b, act=act, clamp=clamp))(xj, jb))
        for got in (tba.bias_act_ref(xt, tb, act=act, clamp=clamp),
                    tba.bias_act(xt, tb, act=act, clamp=clamp)):
            np.testing.assert_allclose(_nhwc(got), ref, atol=1e-6, err_msg=f"{bias} {clamp}")

    clamp = 1.0 if act in ("lrelu", "relu", "swish") else None

    def jf(x_, b_):
        return jnp.sum(jnp.square(jba.bias_act(x_, b_, act=act, clamp=clamp)))

    jgx, jgb, jh = jax.jit(lambda a, b: jax.grad(jf, argnums=(0, 1))(a, b) + (
        jax.grad(lambda x_: jnp.sum(jnp.square(jax.grad(jf)(x_, b))))(a),))(xj, bj)
    xt, bt = xt.clone().requires_grad_(True), bt.clone().requires_grad_(True)
    y = tba.bias_act(xt, bt, act=act, clamp=clamp)
    gx, gb = torch.autograd.grad(y.square().sum(), (xt, bt), create_graph=True)
    (h,) = torch.autograd.grad(gx.square().sum(), xt)
    for got, ref, bar in ((_nhwc(gx.detach()), jgx, 1e-5), (gb.detach().numpy(), jgb, 1e-5),
                          (_nhwc(h), jh, 1e-4)):
        _close_scaled(got, np.asarray(ref), bar)


def _close_scaled(got, ref, bar):
    """max|Δ| ≤ bar·max(1, max|ref|): the bias gradient sums 32 entries and
    reaches ~150 (selu), where one float32 ulp is already 1.5e-5."""
    assert np.abs(got - ref).max() <= bar * max(1.0, np.abs(ref).max())


def test_bias_act_2d_alpha_gain_and_bf16():
    """(N, C) features with the bias on dim 1, lrelu's alpha, an explicit
    gain; and the bf16 plain version against JAX's bf16 chain (both round
    after every step; 2e-2, two bf16 ulps at the values' scale)."""
    rng = np.random.RandomState(20)
    x, b = rng.randn(16, 48).astype(np.float32), rng.randn(48).astype(np.float32)
    ref = jba.bias_act(jnp.asarray(x), jnp.asarray(b), act="lrelu", alpha=0.1, gain=3.0,
                       clamp=2.5)
    got = tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), act="lrelu", alpha=0.1,
                       gain=3.0, clamp=2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    ref16 = jba.bias_act(jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                         act="lrelu", clamp=256.0)
    got16 = tba.bias_act(torch.from_numpy(x).bfloat16(), torch.from_numpy(b).bfloat16(),
                         act="lrelu", clamp=256.0)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(ref16, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_bias_act_on_cpu_launches_nothing_and_refuses_other_devices():
    before = tba.bias_act_fwd.launches
    tba.bias_act(torch.zeros(2, 3), torch.zeros(3))
    assert tba.bias_act_fwd.launches == before
    with pytest.raises(ValueError):
        tba.bias_act_fwd(torch.empty(2, 3, device="meta"), None)


# --- (b) row_shift (B3) ----------------------------------------------------------

def _rows(B=7, L=40, scale=90.0, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L).astype(np.float32),
            ((rng.rand(B) - 0.5) * scale).astype(np.float32))


@pytest.mark.parametrize("l_out", [24, 65])
def test_row_shift_matches_pallas_interpret(l_out):
    """Forward at a crop (l_out < L, the ADA warp's) and the adjoint's
    geometry (l_out > L), offsets on both sides of the frame: the
    plain version and the Function against the Pallas kernel, 1e-6 (the bar
    of tests/test_row_shift.py)."""
    x, off = _rows()
    ref = np.asarray(jax.jit(lambda a, o: jrs.row_shift(a, o, True, l_out=l_out))(
        jnp.asarray(x), jnp.asarray(off)))
    oracle = np.asarray(jwarp._frac_shift_rows_2d(jnp.asarray(x), jnp.asarray(off), l_out))
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    for got in (trs.row_shift_ref(xt, ot, l_out), trs.row_shift(xt, ot, l_out)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-6)


def test_row_shift_integer_out_of_frame_and_frac_shift_rows():
    x, _ = _rows(B=10, L=16)
    off = np.array([-3, 0, 5, 15, -16, 16, 17, -17, 1000, -1000], np.float32)
    ref = np.asarray(jwarp._frac_shift_rows_2d(jnp.asarray(x), jnp.asarray(off)))
    got = trs.row_shift(torch.from_numpy(x), torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got[-2:]).max() == 0.0
    rng = np.random.RandomState(3)
    x4 = rng.randn(2, 5, 40, 3).astype(np.float32)
    off4 = ((rng.rand(2, 5) - 0.5) * 90).astype(np.float32)
    ref4 = jax.jit(lambda a, o: jrs.frac_shift_rows(a, o, True, l_out=30))(
        jnp.asarray(x4), jnp.asarray(off4))
    got4 = trs.frac_shift_rows(torch.from_numpy(x4), torch.from_numpy(off4), 30)
    np.testing.assert_allclose(got4.numpy(), np.asarray(ref4), atol=1e-6)


def test_row_shift_adjoint_and_second_order_match_jax():
    """The backward of the cropped shift is the transpose of its (l_out × L)
    interpolation matrix, as JAX's ``linear_call`` gives; first and second
    order of sum(sin(shift)) against JAX's, 1e-6 and 1e-5 (tests/
    test_row_shift.py:53-56).  On the CPU nothing launches."""
    x, off = _rows(B=4, L=40)
    l_out = 16
    ct = np.random.RandomState(4).randn(4, l_out).astype(np.float32)
    oj = jnp.asarray(off)
    f = lambda a: jnp.sum(jnp.sin(jrs.row_shift(a, oj, True, l_out=l_out)))  # noqa: E731

    @jax.jit  # one trace of the interpreted kernel for all three
    def jax_side(a, c):
        _, vjp = jax.vjp(lambda b: jrs.row_shift(b, oj, True, l_out=l_out), a)
        return (vjp(c)[0], jax.grad(f)(a),
                jax.grad(lambda b: jnp.sum(jax.grad(f)(b) ** 2))(a))
    jadj, jg, jh = jax_side(jnp.asarray(x), jnp.asarray(ct))

    before = trs.row_shift_fwd.launches
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trs.row_shift(xt, torch.from_numpy(off), l_out)
    (adj,) = torch.autograd.grad(y, xt, torch.from_numpy(ct), retain_graph=True)
    np.testing.assert_allclose(adj.numpy(), np.asarray(jadj), atol=1e-6)
    (g,) = torch.autograd.grad(torch.sin(y).sum(), xt, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), atol=1e-6)
    (h,) = torch.autograd.grad(g.square().sum(), xt)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    assert trs.row_shift_fwd.launches == before


def test_row_shift_bf16_lerps_in_f32():
    x, off = _rows(L=32)
    ref = jax.jit(lambda a, o: jrs.row_shift(a, o, True))(jnp.asarray(x, jnp.bfloat16),
                                                           jnp.asarray(off))
    got = trs.row_shift(torch.from_numpy(x).bfloat16(), torch.from_numpy(off))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
