"""The port's StyleGAN2 network-pickle importer against the JAX package's, on
the CPU.

The test writes a TF-era snapshot of a toy G and D: a 3-tuple of
``dnnlib.tflib.network.Network`` stand-ins (registered in ``sys.modules``
only while pickling) whose variables follow the names and layouts that
``convert_tf_generator`` / ``convert_tf_discriminator`` read.  Both
importers read it without TensorFlow; the port's state dicts equal the JAX
variables passed through ``stylegan2_state_dict_from_jax``, exactly (numpy
relayout only), and the port's G built from them draws what the JAX G draws.
A pickle of the port's own modules goes through the torch branch.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.io import stylegan_import as jimport
from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu_torch.io import stylegan_import as timport
from ic_gan_tpu_torch.io.convert import stylegan2_state_dict_from_jax
from ic_gan_tpu_torch.models import stylegan2 as tsg2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES, FMAP_BASE, FMAP_MAX, ZDIM = 16, 128, 32, 16     # port channel_base 256


def _ch(res):
    return min((FMAP_BASE * 2) // res, FMAP_MAX)


def _net(cls, rng, static_kwargs, variables, components=None):
    n = cls()
    n.version = 4
    n.static_kwargs = static_kwargs
    n.variables = [(k, np.asarray(rng.randn(*s), np.float32) * 0.3) for k, s in variables]
    n.components = components or {}
    return n


def _tf_generator(cls, rng):
    mapping = _net(cls, rng, {}, [("Dense0/weight", (ZDIM, ZDIM)), ("Dense0/bias", (ZDIM,)),
                                  ("Dense1/weight", (ZDIM, ZDIM)), ("Dense1/bias", (ZDIM,))])
    syn = [("4x4/Const/const", (1, _ch(4), 4, 4)),
           ("4x4/Conv/weight", (3, 3, _ch(4), _ch(4))), ("4x4/Conv/bias", (_ch(4),)),
           ("4x4/Conv/noise_strength", ()), ("4x4/Conv/mod_weight", (ZDIM, _ch(4))),
           ("4x4/Conv/mod_bias", (_ch(4),)), ("4x4/ToRGB/weight", (1, 1, _ch(4), 3)),
           ("4x4/ToRGB/bias", (3,)), ("4x4/ToRGB/mod_weight", (ZDIM, _ch(4))),
           ("4x4/ToRGB/mod_bias", (_ch(4),)), ("noise0", (1, 1, 4, 4))]
    for r in (8, 16):
        ci, co, k = _ch(r // 2), _ch(r), int(np.log2(r))
        for op, cin in (("Conv0_up", ci), ("Conv1", co)):
            syn += [(f"{r}x{r}/{op}/weight", (3, 3, cin, co)), (f"{r}x{r}/{op}/bias", (co,)),
                    (f"{r}x{r}/{op}/noise_strength", ()),
                    (f"{r}x{r}/{op}/mod_weight", (ZDIM, cin)),
                    (f"{r}x{r}/{op}/mod_bias", (cin,))]
        syn += [(f"noise{2 * k - 5}", (1, 1, r, r)), (f"noise{2 * k - 4}", (1, 1, r, r)),
                (f"{r}x{r}/ToRGB/weight", (1, 1, co, 3)), (f"{r}x{r}/ToRGB/bias", (3,)),
                (f"{r}x{r}/ToRGB/mod_weight", (ZDIM, co)), (f"{r}x{r}/ToRGB/mod_bias", (co,))]
    kwargs = dict(latent_size=ZDIM, dlatent_size=ZDIM, resolution=RES, num_channels=3,
                  mapping_layers=2, fmap_base=FMAP_BASE, fmap_max=FMAP_MAX,
                  nonlinearity="lrelu", resample_kernel=[1, 3, 3, 1])
    return _net(cls, rng, kwargs, [("dlatent_avg", (ZDIM,))],
                {"mapping": mapping, "synthesis": _net(cls, rng, {}, syn)})


def _tf_discriminator(cls, rng):
    v = [(f"{RES}x{RES}/FromRGB/weight", (1, 1, 3, _ch(RES))),
         (f"{RES}x{RES}/FromRGB/bias", (_ch(RES),))]
    for r in (16, 8):
        ci, co = _ch(r), _ch(r // 2)
        v += [(f"{r}x{r}/Conv0/weight", (3, 3, ci, ci)), (f"{r}x{r}/Conv0/bias", (ci,)),
              (f"{r}x{r}/Conv1_down/weight", (3, 3, ci, co)), (f"{r}x{r}/Conv1_down/bias", (co,)),
              (f"{r}x{r}/Skip/weight", (1, 1, ci, co))]
    v += [("4x4/Conv/weight", (3, 3, _ch(4) + 1, _ch(4))), ("4x4/Conv/bias", (_ch(4),)),
          ("4x4/Dense0/weight", (_ch(4) * 16, _ch(4))), ("4x4/Dense0/bias", (_ch(4),)),
          ("Output/weight", (_ch(4), 1)), ("Output/bias", (1,))]
    kwargs = dict(resolution=RES, num_channels=3, fmap_base=FMAP_BASE, fmap_max=FMAP_MAX,
                  nonlinearity="lrelu", resample_kernel=[1, 3, 3, 1], mbstd_group_size=2)
    return _net(cls, rng, kwargs, v)


@pytest.fixture(scope="module")
def tf_pickle(tmp_path_factory):
    """A TF snapshot pickled through stand-in ``dnnlib`` modules, which are
    removed again before anything reads it."""
    names = ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}
    Network = type("Network", (), {"__module__": "dnnlib.tflib.network"})
    mods["dnnlib.tflib.network"].Network = Network
    sys.modules.update(mods)
    try:
        nets = (_tf_generator(Network, np.random.RandomState(0)),
                _tf_discriminator(Network, np.random.RandomState(1)),
                _tf_generator(Network, np.random.RandomState(2)))
        path = tmp_path_factory.mktemp("legacy") / "tf_snapshot.pkl"
        with open(path, "wb") as f:
            pickle.dump(nets, f)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    return str(path)


def _port_cfg(kw):
    return tsg2.StyleGAN2Config(
        img_resolution=kw["img_resolution"], z_dim=kw["z_dim"], c_dim=kw["c_dim"], h_dim=0,
        w_dim=kw["w_dim"], channel_base=kw["synthesis_kwargs"]["channel_base"],
        channel_max=kw["synthesis_kwargs"]["channel_max"],
        num_mapping_layers=kw["mapping_kwargs"]["num_layers"], num_fp16_res=0,
        conv_clamp=None, mbstd_group_size=2)


def test_tf_pickle_converts_as_jax_does(tf_pickle):
    ours, theirs = timport.load_network_pkl(tf_pickle), jimport.load_network_pkl(tf_pickle)
    assert set(ours) == set(theirs) == {"G", "D", "G_ema"}
    for name in ours:
        sd, kw = ours[name]
        want = stylegan2_state_dict_from_jax(theirs[name][0])
        assert kw == theirs[name][1] and set(sd) == set(want), name
        for k, t in want.items():
            assert sd[k].dtype == t.dtype and torch.equal(sd[k], t), (name, k)
        cfg = _port_cfg(ours["G"][1])
        module = (tsg2.Discriminator if name == "D" else tsg2.Generator)(cfg, device="cpu")
        timport.convert_state_dict(sd, target=module)       # names and shapes hold
        module.load_state_dict(sd)


def test_loaded_generator_matches_jax(tf_pickle):
    """The port's G from the converted G_ema against the JAX G from the JAX
    importer's variables: the same z, constant noise, f32 bar of
    test_torch_port_sg2.py (1e-4 of max(1, max|JAX|))."""
    sd, kw = timport.load_network_pkl(tf_pickle)["G_ema"]
    variables = jimport.load_network_pkl(tf_pickle)["G_ema"][0]
    cfg = _port_cfg(kw)
    g = tsg2.Generator(cfg, device="cpu")
    g.load_state_dict(sd)
    jg = jsg2.Generator(jsg2.StyleGAN2Config(**vars(cfg)))
    z = np.random.RandomState(7).randn(3, ZDIM).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, z_: jg.apply(v, z_, None, None, noise_mode="const"))(
        variables, jnp.asarray(z)))
    with torch.no_grad():
        got = g(torch.from_numpy(z), noise_mode="const").permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_torch_snapshot_of_port_modules(tmp_path):
    """A pickled dict of modules takes the torch branch; state dicts come
    back as saved, the resample filters dropped (the port has none)."""
    cfg = _port_cfg(dict(img_resolution=RES, z_dim=ZDIM, c_dim=0, w_dim=ZDIM,
                         synthesis_kwargs=dict(channel_base=256, channel_max=FMAP_MAX),
                         mapping_kwargs=dict(num_layers=2)))
    gen = torch.Generator().manual_seed(0)
    g, d = tsg2.Generator(cfg, device="cpu", generator=gen), \
        tsg2.Discriminator(cfg, device="cpu", generator=gen)
    path = tmp_path / "network-snapshot.pkl"
    with open(path, "wb") as f:
        pickle.dump({"G": g, "D": d, "G_ema": g}, f)
    out = timport.load_network_pkl(str(path))
    assert set(out) == {"G", "D", "G_ema"}
    for name, module in (("G", g), ("D", d), ("G_ema", g)):
        sd, kw = out[name]
        assert kw == {} and set(sd) == set(module.state_dict())
        assert all(torch.equal(sd[k], v) for k, v in module.state_dict().items())
    upstream = dict(out["G"][0], **{"synthesis.b4.resample_filter": torch.ones(4, 4)})
    assert set(timport.convert_state_dict(upstream, target=g)) == set(g.state_dict())
    bad = dict(upstream, **{"mapping.fc0.bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="mapping.fc0.bias"):
        timport.convert_state_dict(bad, target=g)
    with pytest.raises(KeyError):
        timport.convert_state_dict({"mapping.fc0.bias": torch.zeros(ZDIM)}, target=g)
