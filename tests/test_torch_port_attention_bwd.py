"""The port's SA-GAN attention backward against the JAX package, on the CPU.

``sagan_attention_bwd_ref`` (the plain version of ``csrc/sagan_attention_bwd.cu``)
is held against the Pallas backward ``_attention_bwd_impl`` in interpret mode,
at the shapes ``tests/test_pallas_attention.py`` uses, with its tolerances:
atol 1e-4 in f32; atol 5e-2 and rtol 2e-2 in bf16, where one output ulp is
about 0.8 % of the magnitude.  ``SAGANAttention`` on CPU tensors is held
against autograd through ``sagan_attention_ref``.  Inputs come from numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ic_gan_tpu.ops.pallas import attention as jattn
from ic_gan_tpu_torch.ops import attention as tattn


def _inputs(shape, seed=0):
    n, lq, lk, d, dv = shape
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((n, lq, d), (n, lk, d), (n, lk, dv), (n, lq, dv))]


@pytest.mark.parametrize("shape,dtype,tol", [
    # Lq 1024 > the Pallas q-tile 512: dφ/dg sum over two q-tiles there.
    ((2, 1024, 128, 4, 8), "float32", dict(atol=1e-4)),
    # bf16 at the 128² model's d 24, dv 96, scaled down in Lq and Lk.
    ((1, 512, 256, 24, 96), "bfloat16", dict(atol=5e-2, rtol=2e-2)),
])
def test_bwd_ref_matches_pallas_backward(shape, dtype, tol):
    arrays = _inputs(shape)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    ref = jattn._attention_bwd_impl(*jargs, interpret=True)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = tattn.sagan_attention_bwd_ref(*targs)
    for name, r, t, inp in zip(("dtheta", "dphi", "dg"), ref, got, targs):
        assert t.dtype == inp.dtype and t.shape == inp.shape, name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32),
                                   err_msg=name, **tol)


def test_function_cpu_grads_match_autograd_through_plain_forward():
    theta, phi, g, _ = (torch.from_numpy(a) for a in _inputs((2, 100, 25, 6, 10), seed=1))

    def grads(fn):
        args = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
        torch.tanh(fn(*args)).sum().backward()
        return [a.grad for a in args]

    before = (tattn.sagan_attention_fwd.launches, tattn.sagan_attention_bwd.launches)
    got = grads(tattn.sagan_attention)
    assert (tattn.sagan_attention_fwd.launches, tattn.sagan_attention_bwd.launches) == before
    for name, t, r in zip(("dtheta", "dphi", "dg"), got, grads(tattn.sagan_attention_ref)):
        torch.testing.assert_close(t, r, rtol=1e-5, atol=1e-6, msg=name)


def test_function_is_first_order_only():
    theta, phi, g, _ = (torch.from_numpy(a).requires_grad_(True)
                        for a in _inputs((1, 16, 4, 4, 8), seed=2))
    out = tattn.sagan_attention(theta, phi, g)
    (gt,) = torch.autograd.grad(out.sum(), theta, create_graph=True)
    with pytest.raises(RuntimeError):
        gt.sum().backward()


def test_bwd_wrapper_refuses_other_devices():
    # A tensor off the CPU never takes the plain version.
    meta = [torch.empty(2, 16, 8, device="meta"), torch.empty(2, 4, 8, device="meta"),
            torch.empty(2, 4, 8, device="meta"), torch.empty(2, 16, 8, device="meta")]
    with pytest.raises(ValueError):
        tattn.sagan_attention_bwd(*meta)
    with pytest.raises(ValueError):
        tattn.sagan_attention_bwd(torch.zeros(2, 16, 8), *meta[1:])
