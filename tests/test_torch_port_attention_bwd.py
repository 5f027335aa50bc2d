"""The port's SA-GAN attention backward against the JAX package, on the CPU.

``sagan_attention_bwd_ref`` (the plain version of ``csrc/sagan_attention_bwd.cu``)
is held against the Pallas backward ``_attention_bwd_impl`` in interpret mode,
at the shapes ``tests/test_pallas_attention.py`` uses, with its tolerances:
atol 1e-4 in f32; atol 5e-2 and rtol 2e-2 in bf16, where one output ulp is
about 0.8 % of the magnitude; both in its explicit form and in the saved-state
forms that take the forward's log-sum-exp (and output).  The plain forward's
log-sum-exp is held against ``jax.nn.logsumexp``.  ``SAGANAttention`` on CPU
tensors is held against autograd through ``sagan_attention_ref``.  Inputs
come from numpy.
"""

import functools

import jax
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


BWD_CASES = [
    # Lq 1024 > the Pallas q-tile 512: dφ/dg sum over two q-tiles there.
    ((2, 1024, 128, 4, 8), "float32", dict(atol=1e-4)),
    # bf16 at the 128² model's d 24, dv 96, scaled down in Lq and Lk.
    ((1, 512, 256, 24, 96), "bfloat16", dict(atol=5e-2, rtol=2e-2)),
]


@functools.lru_cache(maxsize=None)
def _pallas_bwd(shape, dtype):
    """The Pallas backward in interpret mode, once per case for this file."""
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in _inputs(shape)]
    return [np.asarray(r, np.float32) for r in jattn._attention_bwd_impl(*jargs, interpret=True)]


def _torch_inputs(shape, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in _inputs(shape)]


def _assert_grads_match(got, ref, targs, tol):
    for name, t, r, inp in zip(("dtheta", "dphi", "dg"), got, ref, targs):
        assert t.dtype == inp.dtype and t.shape == inp.shape, name
        np.testing.assert_allclose(t.float().numpy(), r, err_msg=name, **tol)


@pytest.mark.parametrize("shape,dtype,tol", BWD_CASES)
def test_bwd_ref_matches_pallas_backward(shape, dtype, tol):
    targs = _torch_inputs(shape, dtype)
    _assert_grads_match(tattn.sagan_attention_bwd_ref(*targs), _pallas_bwd(shape, dtype),
                        targs, tol)


@pytest.mark.parametrize("form", ["lse", "lse and o"])
@pytest.mark.parametrize("shape,dtype,tol", BWD_CASES)
def test_saved_state_bwd_ref_matches_pallas_backward(shape, dtype, tol, form):
    # The kernel's contract takes the forward's lse and forms delta =
    # rowsum(dp⊙p); the "lse and o" form takes delta = rowsum(do⊙o) from an
    # f32 output of the same (bf16-valued) inputs.
    theta, phi, g, do = _torch_inputs(shape, dtype)
    o, lse = tattn.sagan_attention_ref(theta.float(), phi.float(), g.float(),
                                       return_lse=True)
    kw = dict(lse=lse) if form == "lse" else dict(lse=lse, o=o)
    got = tattn.sagan_attention_bwd_ref(theta, phi, g, do, **kw)
    _assert_grads_match(got, _pallas_bwd(shape, dtype), (theta, phi, g), tol)


def test_bf16_output_is_too_coarse_for_delta():
    # Why the kernel forms delta from dp⊙p: with the bf16 forward's output,
    # rowsum(do⊙o) moves ds = p⊙(dp − delta) past the bf16 bar where one key
    # dominates a row (p is rounded to bf16 inside o, then o itself).
    shape, dtype, tol = BWD_CASES[1]
    theta, phi, g, do = _torch_inputs(shape, dtype)
    o, lse = tattn.sagan_attention_ref(theta, phi, g, return_lse=True)
    assert o.dtype == torch.bfloat16
    got = tattn.sagan_attention_bwd_ref(theta, phi, g, do, lse=lse, o=o)
    worst = max(float(np.max(np.abs(t.float().numpy() - r)
                             / (tol["atol"] + tol["rtol"] * np.abs(r))))
                for t, r in zip(got, _pallas_bwd(shape, dtype)))
    assert worst > 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_lse_matches_jax_logsumexp(dtype):
    theta, phi, g, _ = _inputs((2, 256, 64, 24, 96), seed=3)
    jt, jp = (jnp.asarray(a, getattr(jnp, dtype)).astype(jnp.float32) for a in (theta, phi))
    ref = jax.nn.logsumexp(jnp.einsum("nqd,nkd->nqk", jt, jp,
                                      precision=jax.lax.Precision.HIGHEST), axis=-1)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (theta, phi, g)]
    out, lse = tattn.sagan_attention_ref(*targs, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 256)
    torch.testing.assert_close(out, tattn.sagan_attention_ref(*targs), rtol=0, atol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


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
            torch.empty(2, 4, 8, device="meta"), torch.empty(2, 16, 8, device="meta"),
            torch.empty(2, 16, device="meta")]
    with pytest.raises(ValueError):
        tattn.sagan_attention_bwd(*meta)
    with pytest.raises(ValueError):
        tattn.sagan_attention_bwd(torch.zeros(2, 16, 8), *meta[1:])
    with pytest.raises(ValueError):
        tattn.sagan_attention_bwd(*meta[:4], torch.zeros(2, 16))
