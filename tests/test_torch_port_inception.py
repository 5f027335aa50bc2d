"""The port's InceptionV3 (``models/inception.py``) and its weight converter
(``io/convert.py:inception_state_dict_from_jax``) against the JAX package,
on the CPU.

Weights: ``tests/test_inception_graph.py:synthetic_state_dict`` (every
torchvision tensor seeded by its name) and the port's random init from a
seed, converted to JAX variables by ``load_torch_inception`` (no JAX
init).  The port is held to the committed
golden outputs at ``test_golden_outputs``' bars, to the JAX forward in f32
at the same bars and in the bf16 mode at the drift bars of
``tests/test_metrics_and_tools.py::test_inception_bf16_deploy_drift``, and
the converter to the state dict bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.models import inception as jinception
from ic_gan_tpu_torch.io.convert import inception_state_dict_from_jax
from ic_gan_tpu_torch.models import inception as tinception
from test_inception_graph import GOLDEN_PATH, synthetic_state_dict, torchvision_inception_v3_manifest
from test_torch_port_classcond import _one_torch_thread, cheap_jit, in_background  # noqa: F401

DROPPED = ("AuxLogits", "num_batches_tracked")


def _weights(sd):
    """(torchvision state dict, JAX variables, the port's f32 and bf16 nets)."""
    variables = jinception.load_torch_inception(sd)
    tsd = inception_state_dict_from_jax(variables)
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        nets[dtype] = tinception.InceptionV3(dtype=dtype, device="cpu").eval()
        nets[dtype].load_state_dict(tsd)
    return sd, variables, nets


@pytest.fixture(scope="module")
def weights():
    return _weights(synthetic_state_dict())


@pytest.fixture(scope="module")
def random_weights():
    """The port's random init from a seed (He-normal convs, batch norm the
    identity), under which the pool features follow the input; under the
    synthetic weights they vary across inputs by about f32 rounding only."""
    net = tinception.InceptionV3(device="cpu", generator=torch.Generator().manual_seed(17))
    return _weights({k: v.numpy() for k, v in net.state_dict().items()})


@functools.lru_cache(maxsize=None)
def _jax_apply(dtype):
    """The JAX forward, jitted once per dtype for the module."""
    return cheap_jit(jinception.InceptionV3(dtype=dtype).apply)


def _port(net, x_nhwc):
    with torch.no_grad():
        pool, logits = net(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    assert pool.dtype == logits.dtype == torch.float32  # an f32 head whatever the trunk
    return pool.numpy(), logits.numpy()


def test_golden_outputs(weights):
    """The JAX package's golden pool and logits (75² input resized to 299²)."""
    _, _, nets = weights
    golden = np.load(GOLDEN_PATH)
    x = np.random.RandomState(1234).uniform(-1.0, 1.0, (2, 75, 75, 3)).astype(np.float32)
    pool, logits = _port(nets[torch.float32], x)
    np.testing.assert_allclose(pool, golden["pool"], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(logits, golden["logits"], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_forward_matches_jax_f32_and_bf16(which, request):
    """32² input resized to 299², batch 2: f32 at the golden bars; the bf16
    mode's drift from its own f32 and its gap to JAX's bf16 within max
    0.15 and mean 0.02 of the mean |pool| (the JAX drift test's bars)."""
    _, variables, nets = request.getfixturevalue(
        "weights" if which == "synthetic" else "random_weights")
    x = np.random.RandomState(7).uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    jax_side = in_background(lambda: {dtype: tuple(np.asarray(a) for a in _jax_apply(dtype)(
        variables, x)) for dtype in (jnp.float32, jnp.bfloat16)})
    pool, logits = _port(nets[torch.float32], x)
    pool16, _ = _port(nets[torch.bfloat16], x)
    ref = jax_side.result()
    np.testing.assert_allclose(pool, ref[jnp.float32][0], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(logits, ref[jnp.float32][1], atol=2e-3, rtol=2e-3)
    scale = np.abs(pool).mean()
    for other in (pool, ref[jnp.bfloat16][0]):
        gap = np.abs(pool16 - other)
        assert gap.max() < 0.15 * scale and gap.mean() < 0.02 * scale, (gap.max(), scale)


def test_state_dict_from_jax_is_torchvisions_bit_for_bit(weights):
    """``inception_state_dict_from_jax(load_torch_inception(sd))`` is ``sd``
    less its aux head and counters, bit for bit; the names load strictly
    into the port's net, so a torchvision ``.pth`` does too."""
    sd, variables, nets = weights
    want = {k: v for k, v in sd.items() if not any(d in k for d in DROPPED)}
    got = inception_state_dict_from_jax(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(tinception.load_torch_inception(sd)) == set(want)
    assert set(nets[torch.float32].state_dict()) == set(want)
    shapes = torchvision_inception_v3_manifest()
    assert all(tuple(t.shape) == shapes[k] for k, t in nets[torch.float32].state_dict().items())


def test_resize_matches_jax_grid():
    """``F.interpolate(align_corners=True)`` against the JAX package's
    separable resize matrices, up and down, f32."""
    x = np.random.RandomState(3).randn(2, 13, 21, 3).astype(np.float32)
    resize = jax.jit(jinception.resize_bilinear_align_corners, static_argnums=(1, 2))
    for size in ((299, 299), (5, 8)):
        want = np.asarray(resize(jnp.asarray(x), *size))
        got = tinception.resize_bilinear_align_corners(
            torch.from_numpy(x).permute(0, 3, 1, 2), *size).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
