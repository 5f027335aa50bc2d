"""The port's DiffAugment (``data/augment.py``) against the JAX package's, on
the CPU.

The port takes each function's random draw explicitly; ``jax_draws``
replays the JAX key splits (``diff_augment`` splits its key once per
function, ``rand_translation`` and ``rand_cutout`` split theirs in two) and
hands the port the same values.  Each op and ``diff_augment`` on an NCHW
batch against the NHWC JAX one, in f32 at atol 1e-6, with the gradient of a
fixed scalar of the output.  H 14 and W 12 take both sides of cutout's
``H + (1 - ch % 2)`` centre range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.data import augment as jaug
from ic_gan_tpu_torch.data import augment as taug

N, C, H, W = 4, 3, 14, 12
ATOL = 1e-6
OPS = ["rand_brightness", "rand_saturation", "rand_contrast", "rand_translation",
       "rand_cutout"]


def jax_draw(fn_name, key, shape, dtype):
    """The draw that JAX's ``fn_name(key, x)`` takes, for an NHWC ``shape``,
    as the port's argument."""
    n, h, w, _ = shape
    if fn_name == "rand_translation":
        sy, sx = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
        ry, rx = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.randint(ry, (n,), -sy, sy + 1))),
                torch.from_numpy(np.array(jax.random.randint(rx, (n,), -sx, sx + 1))))
    if fn_name == "rand_cutout":
        ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
        ry, rx = jax.random.split(key)
        oy = jax.random.randint(ry, (n, 1, 1), 0, h + (1 - ch % 2))
        ox = jax.random.randint(rx, (n, 1, 1), 0, w + (1 - cw % 2))
        return (torch.from_numpy(np.array(oy).reshape(n)),
                torch.from_numpy(np.array(ox).reshape(n)))
    u = jax.random.uniform(key, (n, 1, 1, 1), dtype=dtype)
    return torch.from_numpy(np.array(u).reshape(n))


def jax_draws(key, policy, shape, dtype):
    """The draws of ``ic_gan_tpu.data.augment.diff_augment(key, x, policy)``
    for an NHWC ``shape``, in the port's order and form."""
    draws = []
    for p in policy.split(",") if policy else []:
        for f in jaug.AUGMENT_FNS[p]:
            key, sub = jax.random.split(key)
            draws.append(jax_draw(f.__name__, sub, shape, dtype))
    return draws


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (N, H, W, C)).astype(np.float32)
    c = rng.randn(N, H, W, C).astype(np.float32)  # the scalar is sum(c ⊙ f(x))
    return x, c


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _check(jfn, tfn, seed):
    """f(x) and d sum(c ⊙ f(x)) / dx on both sides."""
    x, c = _inputs(seed)
    ref, vjp = jax.vjp(jfn, jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(c))
    xt = _nchw(x).requires_grad_(True)
    out = tfn(xt)
    (out * _nchw(c)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                               rtol=0, atol=ATOL)
    return out


@pytest.mark.parametrize("name", OPS)
def test_augment_op_matches_jax(name):
    key = jax.random.PRNGKey(OPS.index(name))
    draw = jax_draw(name, key, (N, H, W, C), jnp.float32)
    out = _check(lambda x: getattr(jaug, name)(key, x),
                 lambda x: getattr(taug, name)(x, draw), seed=OPS.index(name))
    if name == "rand_cutout":      # a window of H/2 × W/2 is zeroed, clipped at the edge
        zeros = (out.detach() == 0).all(dim=1).sum(dim=(1, 2))
        assert (zeros > 0).all() and (zeros <= 7 * 6).all()


@pytest.mark.parametrize("policy", ["color,translation,cutout", "translation", "cutout,color"])
def test_diff_augment_matches_jax(policy):
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, policy, (N, H, W, C), jnp.float32)
    _check(lambda x: jaug.diff_augment(key, x, policy),
           lambda x: taug.diff_augment(x, policy, draws=draws), seed=5)


def test_generator_draws_policy_order_and_checks():
    """Draws from a generator: one per function in policy order, in range,
    the same for the same seed; a wrong count of draws raises; no policy
    leaves x as it is."""
    x = torch.rand(N, C, H, W, dtype=torch.float64) * 2 - 1
    draws = taug.augment_draws("color,translation,cutout", x, torch.Generator().manual_seed(0))
    assert len(draws) == 5
    assert all(d.dtype == torch.float64 and d.shape == (N,) and (d >= 0).all() and (d < 1).all()
               for d in draws[:3])
    (ty, tx), (oy, ox) = draws[3], draws[4]
    assert ty.abs().max() <= 2 and tx.abs().max() <= 2        # int(14/8 + .5), int(12/8 + .5)
    assert oy.max() <= H - 1 and ox.max() <= W                # ch 7 odd, cw 6 even
    a = taug.diff_augment(x, "color,translation,cutout", generator=torch.Generator().manual_seed(0))
    b = taug.diff_augment(x, "color,translation,cutout", draws=draws)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="takes 3 draws"):
        taug.diff_augment(x, "color", draws=draws)
    assert taug.diff_augment(x, "") is x
