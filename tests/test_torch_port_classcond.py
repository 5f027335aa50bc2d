"""The port's class conditioning, norm styles, weight init and ``.pth``
loaders against the JAX package, on the CPU.

Toy geometry (res 32, ``G_ch``/``D_ch`` 8, 10 classes), variables drawn
from numpy on the shapes of the JAX init and converted through the port's
extended key maps: ``SNEmbed``; every ``norm_style`` of G's conditional
batch norm in eval and train mode (running statistics and spectral-norm
state included); the class-only and the class-and-instance (cc_icgan) G and
D; ``apply_weight_init``'s choice of weights and the moments of its draws;
and a reference-layout ``.pth`` bundle the test writes.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.io import torch_import as jimport
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu.models import layers as jlayers
from ic_gan_tpu_torch.io import torch_import as timport
from ic_gan_tpu_torch.io.convert import (
    discriminator_state_dict_from_jax,
    generator_key_map,
    generator_state_dict_from_jax,
)
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import layers as tlayers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHEAP_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compile_async(fn, *args, cheap: bool = True):
    """``jax.jit(fn)`` traced and lowered for ``args`` here, and compiled in
    a thread of its own: XLA compiles without holding the GIL, so whatever
    the caller does next (the port's side of a test, the next trace) runs
    meanwhile.  ``cheap`` takes ``cheap_jit``'s settings, else XLA's
    defaults.  Returns a future of the compiled function."""
    lowered = jax.jit(fn).lower(*args)
    pool = ThreadPoolExecutor(1)
    future = pool.submit(lowered.compile, compiler_options=CHEAP_XLA if cheap else None)
    pool.shutdown(wait=False)
    return future


def in_background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a thread of its own, for the JAX side of a
    test: it compiles and runs without holding the GIL for most of its time,
    so the test runs the port's side meanwhile.  A future of its result."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def cheap_jit(fn):
    """``fn`` jitted, each input signature compiled at its first call with
    XLA's CPU backend at its cheapest settings (optimization level 0, no
    expensive LLVM passes): the same operations in the same precision, a
    fraction of the compile time.  For toy forwards, whose compile outweighs
    their run; the float64 train steps run ten times slower so compiled and
    keep ``jax.jit``.  Arguments are arrays or Python values; the values are
    part of the signature."""
    jitted, cache = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, jax.config.jax_enable_x64, tuple(
            (np.shape(x), np.result_type(x).name) if hasattr(x, "dtype") else (type(x), x)
            for x in leaves))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(compiler_options=CHEAP_XLA)
        return cache[key](*args)

    return call


RES, MB, NC = 32, 4, 10
JCFG = jbiggan.BigGANConfig(resolution=RES, G_ch=8, D_ch=8, G_attn="0", D_attn="0",
                            dim_z=40, n_classes=NC, shared_dim=16, shared_dim_feat=16,
                            instance_sz=24, class_cond=True)
CFG_NAMES = ("resolution", "n_classes", "G_ch", "D_ch", "dim_z", "bottom_width", "G_attn",
             "D_attn", "G_shared", "shared_dim", "hier", "class_cond", "instance_cond",
             "G_shared_feat", "shared_dim_feat", "instance_sz", "D_wide", "num_G_SVs",
             "num_D_SVs", "num_SV_itrs", "SN_eps", "BN_eps", "norm_style")
CONDS = {"class": dict(instance_cond=False), "cc_icgan": {}}


def port_cfg(jcfg, **kw):
    return tbiggan.BigGANConfig(**{**{n: getattr(jcfg, n) for n in CFG_NAMES}, **kw})


def numpy_variables(module, rng, *args):
    """Variables of ``module`` drawn from ``rng`` on the shapes of its init
    (traced, not run): normal kernels, tables and SN state, biases and gains
    off zero and one, batch-norm statistics off their init (a zero standing
    counter), attention gammas 0.5."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, train=True))
    draw = {
        "kernel": lambda sh: rng.randn(*sh) / np.sqrt(np.prod(sh[:-1])),
        "shared": lambda sh: rng.randn(*sh), "embedding": lambda sh: rng.randn(*sh) / 4,
        "u": lambda sh: rng.randn(*sh), "sv": np.ones, "accum_counter": np.zeros,
        "mean": lambda sh: 0.1 * rng.randn(*sh), "var": lambda sh: rng.uniform(0.5, 1.5, sh),
        "bias": lambda sh: 0.1 * rng.randn(*sh),
        "gain": lambda sh: 1.0 + 0.1 * rng.randn(*sh),
        "gamma": lambda sh: np.full(sh, 0.5),
    }

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(draw[k](v.shape).astype(np.float32)) for k, v in node.items()}
    return walk(shapes)


def cond_inputs(rng, jcfg, n=MB):
    z = rng.randn(n, jcfg.effective_dim_z).astype(np.float32)
    label = rng.randint(0, jcfg.n_classes, n).astype(np.int32)
    feats = rng.randn(n, jcfg.instance_sz).astype(np.float32) if jcfg.instance_cond else None
    return z, label, feats


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_g(variables, cfg):
    g = torch.nn.utils.skip_init(tbiggan.Generator, cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(variables, cfg))
    return g


def _port_d(variables, cfg):
    d = torch.nn.utils.skip_init(tbiggan.Discriminator, cfg, device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(variables, cfg))
    return d


def _check_state(net, new_sd, keys_like=(".u0", ".sv0", ".stored_mean", ".stored_var")):
    keys = [k for k in new_sd if k.endswith(keys_like)]
    for k in keys:
        np.testing.assert_allclose(net.state_dict()[k].numpy(), new_sd[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    return keys


# --- SNEmbed ------------------------------------------------------------------

def test_snembed_forward_and_train_update_match_jax():
    rng = np.random.RandomState(0)
    table = rng.randn(NC, 12).astype(np.float32)
    u = rng.randn(1, NC).astype(np.float32)
    idx = rng.randint(0, NC, 6).astype(np.int32)
    variables = {"params": {"embedding": jnp.asarray(table)},
                 "sn": {"u": jnp.asarray(u), "sv": jnp.ones(1)}}
    emb = jlayers.SNEmbed(NC, 12)
    ref, mut = emb.apply(variables, jnp.asarray(idx), update_sn=True, mutable=["sn"])
    ref_eval = emb.apply(variables, jnp.asarray(idx))
    t = tlayers.SNEmbed(NC, 12, device="cpu")
    t.load_state_dict({"weight": torch.from_numpy(table), "u0": torch.from_numpy(u),
                       "sv0": torch.ones(1)})
    got_eval = t.eval()(torch.from_numpy(idx).long())
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(ref_eval), atol=1e-5)
    assert torch.equal(t.u0, torch.from_numpy(u))           # eval keeps the state
    got = t.train()(torch.from_numpy(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(t.u0.numpy(), np.asarray(mut["sn"]["u"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.sv0.numpy(), np.asarray(mut["sn"]["sv"]), rtol=1e-6)
    assert t.u0.shape == (1, NC)                             # u over the table's rows
    # A gradient reaches the table through σ and the gather.
    t.weight.grad = None
    t.train()(torch.from_numpy(idx)).sum().backward()
    assert t.weight.grad is not None and t.weight.grad.abs().sum() > 0


# --- the norm styles ---------------------------------------------------------------

@pytest.mark.parametrize("style", ["gn", "gn_ch_4", "gn_ch_5", "gn_grp_3", "gn_grp_64",
                                   "groupnorm"])
def test_group_norm_group_choice_matches_jax(style):
    """The group count of each ``gn`` spelling (C//N, N, 16; at most C and
    lowered until it divides C) and the normalization, at 24 channels."""
    rng = np.random.RandomState(7)
    x = (2 * rng.randn(3, 5, 4, 24) + 0.5).astype(np.float32)      # NHWC
    ref = jlayers.group_norm(jnp.asarray(x), style)
    got = tlayers.group_norm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                             style)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


NORM_STYLES = ("in", "gn", "nonorm")


@pytest.fixture(scope="module")
def norm_style_refs():
    """Per style: the JAX G in eval and in train mode (one function), its
    variables and inputs; each traced here in turn and compiled in a thread
    of its own (``compile_async``) while the next one traces."""
    out = {}
    for style in NORM_STYLES:
        jcfg = JCFG.replace(norm_style=style)
        rng = np.random.RandomState(1)
        z, label, feats = cond_inputs(rng, jcfg)
        jg = jbiggan.Generator(jcfg)
        variables = numpy_variables(jg, rng, jnp.asarray(z), jnp.asarray(label),
                                    jnp.asarray(feats))

        def both(v, z, label, feats, jg=jg):
            return (jg.apply(v, z, label, feats, train=False),
                    jg.apply(v, z, label, feats, train=True, mutable=["batch_stats", "sn"]))

        args = (variables, z, label, feats)
        out[style] = (compile_async(both, *args), args)
    return out


@pytest.mark.parametrize("style", NORM_STYLES)
def test_norm_style_generator_matches_jax(norm_style_refs, style):
    """The cc_icgan G with ``norm_style`` in eval and in train mode (one JAX
    compile for both): images at atol 1e-4; after the train-mode forward the
    running statistics (``in``) and every SN state as JAX's.  The ``bn``
    style's G is held by the class-conditional test below and by
    ``test_torch_port_generator.py``."""
    cfg = port_cfg(JCFG.replace(norm_style=style))
    compiling, (variables, z, label, feats) = norm_style_refs[style]
    ref_eval, (ref_train, mut) = compiling.result()(variables, z, label, feats)

    g = _port_g(variables, cfg)
    bufs = {k for k in g.state_dict() if ".bn1." in k and not k.split(".")[-2] in ("gain", "bias")}
    want = {"bn": {"stored_mean", "stored_var", "accum_counter"},
            "in": {"stored_mean", "stored_var"}}.get(style, set())
    assert {k.rsplit(".", 1)[-1] for k in bufs} == want, bufs
    with torch.no_grad():
        got_eval = g.eval()(_t(z), _t(label).long(), _t(feats))
        np.testing.assert_allclose(_nhwc(got_eval), np.asarray(ref_eval), atol=1e-4)
        got_train = g.train()(_t(z), _t(label), _t(feats))
    np.testing.assert_allclose(_nhwc(got_train), np.asarray(ref_train), atol=1e-4)
    new = generator_state_dict_from_jax({"params": variables["params"], **mut}, cfg)
    keys = _check_state(g, new)
    n_stats = sum(k.endswith(".stored_mean") for k in keys)
    assert n_stats == (7 if style == "in" else 1)   # 3 blocks × 2 + the output bn


# --- the class-conditional G and D ---------------------------------------------------

@pytest.fixture(scope="module")
def cond_refs():
    """Per conditioning: JAX's G (eval) and D (eval and train) in one
    function, its variables and inputs; traced in turn, compiled in threads
    (``compile_async``)."""
    out = {}
    for cond in CONDS:
        jcfg = JCFG.replace(**CONDS[cond])
        rng = np.random.RandomState(2)
        z, label, feats = cond_inputs(rng, jcfg)
        x = rng.uniform(-1, 1, (MB, RES, RES, 3)).astype(np.float32)
        jf = None if feats is None else jnp.asarray(feats)
        jg, jd = jbiggan.Generator(jcfg), jbiggan.Discriminator(jcfg)
        g_vars = numpy_variables(jg, rng, jnp.asarray(z), jnp.asarray(label), jf)
        d_vars = numpy_variables(jd, rng, jnp.asarray(x), jnp.asarray(label), jf)

        def run(gv, dv, z, label, feats, x, jg=jg, jd=jd):
            return (jg.apply(gv, z, label, feats), jd.apply(dv, x, label, feats),
                    jd.apply(dv, x, label, feats, train=True, mutable=["sn"]))

        args = (g_vars, d_vars, z, label, jf, x)
        out[cond] = (compile_async(run, *args), args, feats)
    return out


@pytest.mark.parametrize("cond", list(CONDS))
def test_class_conditional_generator_and_discriminator_match_jax(cond_refs, cond):
    """G (eval) and D (eval, and train with its SN updates) through the
    extended key maps: class only (D's ``embed`` of the top width) and
    class + instance (``embed`` and ``linear_feat`` of half of it each)."""
    cfg = port_cfg(JCFG.replace(**CONDS[cond]))
    compiling, args, feats = cond_refs[cond]
    g_vars, d_vars, z, label, _, x = args
    ref_g, ref_d, (ref_dt, mut) = compiling.result()(*args)

    g, d = _port_g(g_vars, cfg), _port_d(d_vars, cfg)
    top = cfg.d_arch["out_channels"][-1]
    head = top // 2 if cfg.instance_cond else top
    assert d.embed.weight.shape == (NC, head) and d.embed.u0.shape == (1, NC)
    assert hasattr(d, "linear_feat") == cfg.instance_cond
    assert g.shared.weight.shape == (NC, cfg.shared_dim_eff)
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(g(_t(z), _t(label), _t(feats))), np.asarray(ref_g),
                                   atol=1e-4)
        np.testing.assert_allclose(d(xt, _t(label), _t(feats)).numpy(), np.asarray(ref_d),
                                   rtol=1e-5, atol=1e-4)
        got = d.train()(xt, _t(label).long(), _t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_dt), rtol=1e-5, atol=1e-4)
    new = discriminator_state_dict_from_jax({"params": d_vars["params"], **mut}, cfg)
    assert "embed.u0" in _check_state(d, new, (".u0", ".sv0"))
    with pytest.raises(ValueError, match="needs labels"):
        g(_t(z), None, _t(feats))


# --- weight init ---------------------------------------------------------------------

def test_apply_weight_init_redraws_the_jax_leaves():
    """N02: the re-drawn weights are the JAX package's ``kernel``/
    ``embedding``/``shared`` leaves, mapped to torch names, and nothing else
    moves; the draws have std 0.02 on both sides.  'ortho' changes nothing."""
    cfg = port_cfg(JCFG)
    rng = np.random.RandomState(3)
    z, label, feats = cond_inputs(rng, JCFG)
    jg = jbiggan.Generator(JCFG)
    params = numpy_variables(jg, rng, jnp.asarray(z), jnp.asarray(label),
                             jnp.asarray(feats))["params"]
    redrawn = cheap_jit(lambda p, key: jlayers.apply_weight_init(p, key, style="N02"))(
        params, jax.random.PRNGKey(4))
    flat = lambda tree: {tuple(p.key for p in path): np.asarray(v) for path, v in  # noqa: E731
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    before, after = flat(params), flat(redrawn)
    kmap = {k[1:]: v[0] for k, v in generator_key_map(cfg).items() if k[0] == "params"}
    changed_jax = {kmap[p] for p in before if not np.array_equal(before[p], after[p])}

    g = tbiggan.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    old = {k: v.clone() for k, v in g.named_parameters()}
    tlayers.apply_weight_init(g, "ortho")
    assert all(torch.equal(v, old[k]) for k, v in g.named_parameters())
    tlayers.apply_weight_init(g, "N02", torch.Generator().manual_seed(1))
    changed = {k for k, v in g.named_parameters() if not torch.equal(v, old[k])}
    assert changed == changed_jax and "shared.weight" in changed
    assert "output_layer.0.gain" not in changed and "blocks.1.0.bn1.gain.weight" in changed
    drawn = lambda ws: np.concatenate([w.ravel() for w in ws])  # noqa: E731
    std_port = drawn([p.detach().numpy() for k, p in g.named_parameters() if k in changed]).std()
    std_jax = drawn([after[p] for p in after if kmap[p] in changed]).std()
    np.testing.assert_allclose([std_port, std_jax], [0.02, 0.02], rtol=0.02)


@pytest.mark.parametrize("style", ["glorot", "xavier"])
def test_glorot_init_draws_have_the_glorot_variance(style):
    """Glorot's uniform draws: variance 2/(fan_in + fan_out) of each weight
    (the JAX package's ``xavier_uniform``; the sum of the fans is the same
    for (in, out) and (out, in) layouts), bounded by √3 of its std."""
    cfg = port_cfg(JCFG)
    d = tbiggan.Discriminator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tlayers.apply_weight_init(d, style, torch.Generator().manual_seed(2))
    for name in ("blocks.1.0.conv1.weight", "embed.weight", "linear_feat.weight"):
        w = d.get_parameter(name).detach()
        fans = w.shape[0] * w[0, 0].numel() + w.shape[1] * w[0, 0].numel()
        assert abs(w.var().item() * fans / 2 - 1) < 0.15, name
        assert w.abs().max().item() <= (6 / fans) ** 0.5, name


# --- the reference's .pth bundle -------------------------------------------------------

def test_pth_bundle_loaders(tmp_path):
    """A bundle in the reference's layout: ``G_ema_best1.pth`` (upstream
    keys, no ``accum_counter``) and two best copies of ``state_dict`` with
    the config and FID.  The config as JAX reads it, the best copy by FID,
    and a G whose output equals the source's; an extra key is reported, and
    raises when strict."""
    jcfg_ref = dict(resolution=RES, G_ch=8, D_ch=8, G_attn="0", D_attn="0", dim_z=40,
                    n_classes=NC,
                    shared_dim=16, hier=True, class_cond=True, instance_cond=True,
                    G_shared_feat=True, shared_dim_feat=16)
    got_cfg = timport.config_from_state_dict(jcfg_ref)
    ref_cfg = jimport.config_from_state_dict(jcfg_ref)
    for name in CFG_NAMES:
        assert getattr(got_cfg, name) == getattr(ref_cfg, name), name
    cfg = port_cfg(JCFG, instance_sz=2048)
    assert got_cfg == cfg
    src = tbiggan.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    sd = {k: v for k, v in src.state_dict().items() if not k.endswith("accum_counter")}
    torch.save(sd, tmp_path / "G_ema_best1.pth")
    for i, fid in enumerate((31.5, 12.25)):
        torch.save({"config": jcfg_ref, "best_FID": fid}, tmp_path / f"state_dict_best{i}.pth")
    assert timport.select_best_pth_suffix(str(tmp_path)) == "best1"
    assert timport.select_best_pth_suffix(str(tmp_path / "none")) == ""
    bundle = timport.load_pth_bundle(str(tmp_path), "G_ema", "best1")
    assert set(bundle) == set(sd) and all(torch.is_tensor(v) for v in bundle.values())

    # The config from the bundle's own state_dict_best1.pth.
    g, missing, unexpected = timport.load_generator_from_pth(
        str(tmp_path), suffix="best1", device="cpu")
    assert missing == [] and unexpected == [] and g.cfg == cfg
    assert all(float(b) == 0.0 for k, b in g.state_dict().items() if k.endswith("accum_counter"))
    rng = np.random.RandomState(6)
    z, label, _ = cond_inputs(rng, JCFG)
    feats = rng.randn(MB, 2048).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(g(_t(z), _t(label), _t(feats)), src(_t(z), _t(label), _t(feats)))
    torch.save({**sd, "extra.weight": torch.zeros(1)}, tmp_path / "G.pth")
    _, missing, unexpected = timport.load_generator_from_pth(
        str(tmp_path), "G", cfg=cfg, device="cpu", strict=False)
    assert missing == [] and unexpected == ["extra.weight"]
    with pytest.raises(KeyError, match="extra.weight"):
        timport.load_generator_from_pth(str(tmp_path), "G", cfg=cfg, device="cpu")
