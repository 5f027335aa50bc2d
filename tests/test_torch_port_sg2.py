"""The port's StyleGAN2 generator and discriminator against the JAX package,
on the CPU.

JAX variables are drawn with numpy on the shapes of the JAX init (traced, not
run), converted with ``io/convert.py`` and loaded into the port; the same
numpy inputs go through both.  Toy geometry: 32², channels 64 down to 16,
IC-GAN instance features, two mapping layers.
"""

import numpy as np
import pytest
import torch
from torch.nn.utils import skip_init

import jax
import jax.numpy as jnp

from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu_torch.io.convert import (
    stylegan2_state_dict_from_jax,
    stylegan2_variables_from_state_dict,
)
from ic_gan_tpu_torch.models import stylegan2 as tsg2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 4
BASE = dict(img_resolution=32, z_dim=8, c_dim=0, h_dim=12, w_dim=16, channel_base=512,
            channel_max=64, num_fp16_res=0, num_mapping_layers=2, mbstd_group_size=2)
CASES = {
    "f32": {},
    # Blocks 16² and 32² in bf16, as num_fp16_res 4 puts 32²–256² of the
    # 256² model in bf16.
    # ... and the other architectures (resnet G, skip D), a class label
    # beside the instance features, and a clamp that bites.
    "bf16": dict(num_fp16_res=2, architecture_g="resnet", architecture_d="skip", c_dim=5,
                 conv_clamp=0.5),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _numpy_variables(module, rng, *args, **kw):
    """Variables on the shapes of ``module``'s init: normal weights (the
    mappings' scaled by 1/lr_multiplier, as their init), biases near their
    init, noise strengths off zero so that the noise shows."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, *args, **kw))

    def draw(path, sh):
        name = path[-1]
        if name == "weight":
            scale = 100.0 if path[-2].startswith("fc") and "mapping" in path else 1.0
            return scale * rng.randn(*sh)
        if name == "bias":
            return (1.0 if path[-2] == "affine" else 0.0) + 0.1 * rng.randn(*sh)
        if name == "noise_strength":
            return 0.1 * rng.randn(*sh)
        return rng.randn(*sh) * (0.1 if name == "w_avg" else 1.0)

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else
                np.asarray(draw(path + (k,), v.shape), np.float32) for k, v in node.items()}
    return walk(shapes, ())


@pytest.fixture(scope="module", params=list(CASES))
def nets(request):
    cfg_kw = {**BASE, **CASES[request.param]}
    jcfg = jsg2.StyleGAN2Config(**cfg_kw)
    rng = np.random.RandomState(list(CASES).index(request.param))
    z = rng.randn(N, jcfg.z_dim).astype(np.float32)
    h = rng.randn(N, jcfg.h_dim).astype(np.float32)
    c = np.eye(jcfg.c_dim, dtype=np.float32)[rng.randint(0, jcfg.c_dim, N)] \
        if jcfg.c_dim else None
    x = rng.uniform(-1, 1, (N, 32, 32, 3)).astype(np.float32)
    jg, jd = jsg2.Generator(jcfg), jsg2.Discriminator(jcfg)
    g_vars = _numpy_variables(jg, rng, jnp.asarray(z), c, jnp.asarray(h))
    d_vars = _numpy_variables(jd, rng, jnp.asarray(x), c, jnp.asarray(h))
    tcfg = tsg2.StyleGAN2Config(**cfg_kw)
    g = skip_init(tsg2.Generator, tcfg)
    g.load_state_dict(stylegan2_state_dict_from_jax(g_vars))
    d = skip_init(tsg2.Discriminator, tcfg)
    d.load_state_dict(stylegan2_state_dict_from_jax(d_vars))
    return dict(case=request.param, jg=jg, jd=jd, g_vars=g_vars, d_vars=d_vars, g=g, d=d,
                z=z, h=h, c=c, x=x)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# Bars relative to max(1, max|JAX|).  bf16 blocks: both sides round every
# conv, modulation and bias-activation to bf16 (one ulp is 2^-8 to 2^-7 of a
# value) but order their sums differently; the images sum four torgb layers
# and reach ~7 at random weights.  Measured: max|Δ| 0.079 against max|JAX|
# 7.2, while JAX's own bf16 model differs from its f32 one by 0.095.
ATOL = {"f32": 1e-4, "bf16": 1.5e-2}


def _bar(case, ref):
    return ATOL[case] * max(1.0, float(np.abs(np.asarray(ref)).max()))


def test_generator_forward_matches_jax(nets):
    """noise_mode "const" with nonzero strengths, and (f32 case) "none"."""
    for mode in ("const", "none") if nets["case"] == "f32" else ("const",):
        ref = jax.jit(lambda v: nets["jg"].apply(
            v, jnp.asarray(nets["z"]), nets["c"], jnp.asarray(nets["h"]),
            noise_mode=mode))(nets["g_vars"])
        with torch.no_grad():
            got = nets["g"](_t(nets["z"]), _t(nets["c"]), _t(nets["h"]), noise_mode=mode)
        assert got.shape == (N, 3, 32, 32) and got.dtype == torch.float32
        err = np.abs(_nhwc(got) - np.asarray(ref)).max()
        assert err <= _bar(nets["case"], ref), (mode, err)


def test_discriminator_forward_matches_jax(nets):
    ref = jax.jit(lambda v: nets["jd"].apply(
        v, jnp.asarray(nets["x"]), nets["c"], jnp.asarray(nets["h"])))(nets["d_vars"])
    with torch.no_grad():
        got = nets["d"](_nchw(nets["x"]), _t(nets["c"]), _t(nets["h"]))
    assert got.shape == (N, 1) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= _bar(nets["case"], ref)


def test_mapping_w_avg_update_and_truncation_match_jax(nets):
    if nets["case"] != "f32":
        pytest.skip("mapping runs in f32 in every case; checked once")
    jg, z, h = nets["jg"], jnp.asarray(nets["z"]), jnp.asarray(nets["h"])
    ws, mut = jg.apply(nets["g_vars"], z, None, h, train=True, method=jg.map_ws,
                       mutable=["batch_stats"])
    g = nets["g"]
    w_avg0 = g.mapping.w_avg.clone()
    got = g.map_ws(_t(nets["z"]), None, _t(nets["h"]), update_w_avg=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_allclose(g.mapping.w_avg.numpy(),
                               np.asarray(mut["batch_stats"]["mapping"]["w_avg"]), atol=1e-6)
    trunc = jg.apply(nets["g_vars"], z, None, h, truncation_psi=0.7, truncation_cutoff=3,
                     method=jg.map_ws)
    g.mapping.w_avg.copy_(w_avg0)
    got = g.map_ws(_t(nets["z"]), None, _t(nets["h"]), truncation_psi=0.7, truncation_cutoff=3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(trunc), atol=1e-5)


def test_converter_round_trip_and_names(nets):
    """JAX → port → JAX is the identity, and the port's own modules carry
    exactly the converted names (``mapping.fc{i}``, ``synthesis.b{res}.…``,
    ``b4.fc/out``), so the upstream map of ``io/stylegan_import.py`` holds."""
    for which in ("g", "d"):
        variables = nets[f"{which}_vars"]
        sd = stylegan2_state_dict_from_jax(variables)
        back = stylegan2_variables_from_state_dict(sd)
        flat = lambda t, p=(): {k: v for kk, vv in t.items() for k, v in (  # noqa: E731
            flat(vv, p + (kk,)).items() if isinstance(vv, dict) else [(p + (kk,), vv)])}
        a, b = flat(variables), flat(back)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
        fresh = (tsg2.Generator if which == "g" else tsg2.Discriminator)(
            nets[which].cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        assert set(fresh.state_dict()) == set(sd)
        assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in sd.items()}
    assert "mapping.fc1.weight" in sd and "b4.out.weight" in sd


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)])
@pytest.mark.parametrize("up,demod", [(1, True), (2, True), (1, False)])
def test_modulated_conv2d_matches_jax(dtype, atol, up, demod):
    """bf16 takes the pre-normalization of ``stylegan2.py:81-87``; 3e-2 is a
    few bf16 ulps at the outputs' scale."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 5).astype(np.float32)
    s = (1 + 0.3 * rng.randn(2, 8)).astype(np.float32)
    noise = rng.randn(2, 6 * up, 6 * up, 1).astype(np.float32)
    f = jnp.asarray(np.array([1, 3, 3, 1], np.float32) / 8)
    ref = jax.jit(lambda a, b, c, n: jsg2.modulated_conv2d(
        a, b, c, noise=n, up=up, padding=1, resample_filter=np.asarray(f), demodulate=demod,
        flip_weight=(up == 1)))(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(s),
                                jnp.asarray(noise))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tsg2.modulated_conv2d(_nchw(x).to(tdt), torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))), torch.from_numpy(s),
        noise=_nchw(noise), up=up, padding=1, resample_filter=torch.from_numpy(np.asarray(f)),
        demodulate=demod, flip_weight=(up == 1))
    assert got.dtype == tdt
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32), atol=atol,
                               rtol=0 if dtype == jnp.float32 else 2e-2)


def test_minibatch_std_matches_jax():
    x = np.random.RandomState(8).randn(6, 4, 3, 2).astype(np.float32)  # NHWC, 2 groups of 3
    for group, f in ((3, 1), (2, 2), (None, 1)):
        ref = jax.jit(lambda a: jsg2.minibatch_std(a, group, f))(jnp.asarray(x))
        got = tsg2.minibatch_std(_nchw(x), group, f)
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)
