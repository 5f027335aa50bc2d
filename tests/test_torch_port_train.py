"""The port's BigGAN training path against the JAX package, on the CPU.

One JAX G and D at toy geometry (res 32, ``G_ch``/``D_ch`` 16, attention at
16 in both, so D holds four attention blocks), with variables drawn from
numpy (gamma 0.5 so attention shows in the gradients), converted to the
port's ``state_dict``s.  The same numpy batch and the z that the JAX step draws go
through ``make_train_step`` of both packages (float64 interior, see
``GRAD_REL``); the losses, raw gradients, spectral-norm and batch-norm
state, EMA and Adam-updated parameters after one step are compared.  Two
JAX step compiles in all.
"""

import numpy as np
import optax
import pytest
import torch
from torch.nn.utils import skip_init

import jax
import jax.numpy as jnp

from ic_gan_tpu.io.torch_import import export_discriminator_state_dict
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu.models import layers as jlayers
from ic_gan_tpu.ops import resample as jresample
from ic_gan_tpu.ops import spectral_norm as jsn
from ic_gan_tpu.train import losses as jlosses
from ic_gan_tpu.train import state as jstate
from ic_gan_tpu.train import step as jstep
from ic_gan_tpu_torch.io.convert import (
    discriminator_key_map,
    discriminator_state_dict_from_jax,
    generator_key_map,
    generator_state_dict_from_jax,
    tree_to_torch,
)
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models.layers import CrossReplicaBatchNorm
from ic_gan_tpu_torch.ops import resample as tresample
from ic_gan_tpu_torch.ops import spectral_norm as tsn
from ic_gan_tpu_torch.train import losses as tlosses
from ic_gan_tpu_torch.train import state as tstate
from ic_gan_tpu_torch.train import step as tstep
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401

RES, MB = 32, 4
JCFG = jbiggan.BigGANConfig(resolution=RES, G_ch=16, D_ch=16, G_attn="16", D_attn="16",
                            dim_z=40, shared_dim_feat=32, instance_sz=64)
CFG_NAMES = ("resolution", "G_ch", "D_ch", "dim_z", "bottom_width", "G_attn", "D_attn",
             "hier", "class_cond", "instance_cond", "G_shared_feat", "shared_dim_feat",
             "instance_sz", "D_wide", "num_G_SVs", "num_D_SVs", "num_SV_itrs", "SN_eps",
             "BN_eps", "norm_style")
# adam_eps 1e-3 instead of BigGAN's 1e-6.  With β₁ 0 the first Adam update
# is lr·g/(|g|+ε), about lr·sign(g) once |g| ≫ ε.  At ε 1e-6 a rounding-level
# difference in a D gradient near 0 can flip that entry's step by up to 2·lr,
# and G's gradients, taken through the updated D, then differ by ~1e-3 of
# their largest entry.  At ε 1e-3 the step is smooth in g (slope at most
# lr/ε), so one tight bar holds for every parameter.
TCFG = dict(num_D_accumulations=2, num_G_accumulations=2, ema_start=0,
            G_ortho=1e-3, D_ortho=1e-3, adam_eps=1e-3)
CASES = {"concat-hinge": {}, "split_D-dcgan": dict(split_D=True, loss="dcgan")}


def port_cfg(**kw):
    return tbiggan.BigGANConfig(**{**{n: getattr(JCFG, n) for n in CFG_NAMES}, **kw})


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _hwio_to_oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _numpy_variables(module, rng, *args):
    """Variables of ``module`` drawn from ``rng`` on the shapes of its init
    (traced, not run, so no initializer compiles): normal kernels and SN
    state, biases and gains off zero and one, BN statistics at their init,
    and every attention gamma 0.5 so attention shows in the gradients."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, train=True))
    draw = {
        "kernel": lambda sh: rng.randn(*sh) / np.sqrt(np.prod(sh[:-1])),
        "u": lambda sh: rng.randn(*sh),
        "sv": np.ones, "mean": np.zeros, "var": np.ones, "accum_counter": np.zeros,
        "bias": lambda sh: 0.1 * rng.randn(*sh),
        "gain": lambda sh: 1.0 + 0.1 * rng.randn(*sh),
        "gamma": lambda sh: np.full(sh, 0.5),
    }

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(draw[k](v.shape).astype(np.float32)) for k, v in node.items()}
    return walk(shapes)


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    nD = TCFG["num_D_accumulations"]
    batch = dict(
        x=rng.uniform(-1, 1, (nD, MB, RES, RES, 3)).astype(np.float32),
        feats=rng.randn(nD, MB, JCFG.instance_sz).astype(np.float32),
        gen_feats=rng.randn(nD + TCFG["num_G_accumulations"], MB,
                            JCFG.instance_sz).astype(np.float32),
    )
    g, d = jbiggan.Generator(JCFG), jbiggan.Discriminator(JCFG)
    f0 = jnp.zeros((MB, JCFG.instance_sz))
    g_vars = _numpy_variables(g, rng, jnp.zeros((MB, JCFG.effective_dim_z)), None, f0)
    d_vars = _numpy_variables(d, rng, jnp.zeros((MB, RES, RES, 3)), None, f0)
    return dict(g=g, d=d, batch=batch, g_vars=g_vars, d_vars=d_vars)


def _port_g(variables, dtype=torch.float32):
    g = skip_init(tbiggan.Generator, port_cfg(dtype=dtype), device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(variables, port_cfg()))
    return g.to(dtype)


def _port_d(variables, dtype=torch.float32):
    d = skip_init(tbiggan.Discriminator, port_cfg(dtype=dtype), device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(variables, port_cfg()))
    return d.to(dtype)


# --- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,num_svs", [
    ((24, 16), 1),        # dense (in, out)
    ((3, 3, 8, 16), 1),   # conv HWIO
    ((1, 1, 32, 12), 2),  # 1×1 conv, two singular vectors (Gram-Schmidt)
])
def test_spectral_normalize_update_and_weight_grad_match_jax(shape, num_svs):
    """update=True: the advanced u and σ, and the gradient of a scalar of
    w/σ with respect to W (through the numerator and σ) against jax.grad."""
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32)
    u = rng.randn(num_svs, shape[-1]).astype(np.float32)
    c = rng.randn(*shape).astype(np.float32)  # the scalar is sum(c ⊙ w/σ)
    to_t = (lambda a: a.T) if w.ndim == 2 else _hwio_to_oihw

    _, ju, jsvs = jsn.spectral_normalize(jnp.asarray(w), jnp.asarray(u), update=True)
    jgrad = jax.grad(lambda w_: jnp.sum(jnp.asarray(c) * jsn.spectral_normalize(
        w_, jnp.asarray(u), update=True)[0]))(jnp.asarray(w))

    wt = torch.from_numpy(np.ascontiguousarray(to_t(w))).requires_grad_(True)
    u_t = torch.from_numpy(u)
    w_bar, tu, tsvs = tsn.spectral_normalize(wt, u_t, update=True)
    assert tu is not u_t and not tu.requires_grad and not tsvs.requires_grad
    (torch.from_numpy(np.ascontiguousarray(to_t(c))) * w_bar).sum().backward()
    np.testing.assert_allclose(tsvs.numpy(), np.asarray(jsvs), rtol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wt.grad.numpy(), to_t(np.asarray(jgrad)), rtol=1e-5,
                               atol=1e-6)


def test_avg_pools_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 8, 6).astype(np.float32)          # NCHW
    w = rng.randn(3, 3, 4, 5).astype(np.float32)          # HWIO
    b = rng.randn(5).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    ref = np.asarray(jresample.avg_pool_2x(xj))
    got = tresample.avg_pool_2x(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    ref = np.asarray(jresample.conv3x3_avg_pool_down(xj, jnp.asarray(w))) + b
    got = tresample.conv3x3_avg_pool_down(torch.from_numpy(x),
                                          torch.from_numpy(_hwio_to_oihw(w)),
                                          torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError):
        tresample.conv3x3_avg_pool_down(torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1))


def test_batchnorm_train_mode_matches_jax():
    rng = np.random.RandomState(2)
    x = (1.5 * rng.randn(3, 5, 4, 6) + 0.3).astype(np.float32)  # NCHW
    mean0 = (0.1 * rng.randn(5)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bn = jlayers.CrossReplicaBatchNorm(5)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0),
             "accum_counter": jnp.zeros(1)}
    ref, mut = bn.apply({"batch_stats": stats}, jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                        train=True, mutable=["batch_stats"])
    tbn = CrossReplicaBatchNorm(5, device="cpu").train()
    tbn.stored_mean.copy_(torch.from_numpy(mean0))
    tbn.stored_var.copy_(torch.from_numpy(var0))
    got = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)
    new = mut["batch_stats"]
    np.testing.assert_allclose(tbn.stored_mean.numpy(), np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(tbn.stored_var.numpy(), np.asarray(new["var"]), rtol=1e-5)


@pytest.mark.parametrize("loss", ["hinge", "dcgan"])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(3)
    fake, real = (3 * rng.randn(8, 1)).astype(np.float32), (3 * rng.randn(8, 1)).astype(np.float32)
    jr, jf = jlosses.D_LOSSES[loss](jnp.asarray(fake), jnp.asarray(real))
    tr, tf = tlosses.D_LOSSES[loss](torch.from_numpy(fake), torch.from_numpy(real))
    np.testing.assert_allclose([tr.item(), tf.item()], [float(jr), float(jf)], rtol=1e-6)
    np.testing.assert_allclose(tlosses.G_LOSSES[loss](torch.from_numpy(fake)).item(),
                               float(jlosses.G_LOSSES[loss](jnp.asarray(fake))), rtol=1e-6)


def test_make_optimizer_matches_optax():
    """A few Adam steps with BigGAN's β₁ 0 and with β₁ 0.5, same gradients."""
    rng = np.random.RandomState(4)
    for b1 in (0.0, 0.5):
        p0 = rng.randn(6, 5).astype(np.float32)
        grads = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
        tx = jstate.make_optimizer(2e-4, b1, 0.999, 1e-6)
        jp, opt = jnp.asarray(p0), None
        opt = tx.init(jp)
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        topt = tstate.make_optimizer(2e-4, b1, 0.999, 1e-6)([p])
        for gr in grads:
            upd, opt = tx.update(jnp.asarray(gr), opt, jp)
            jp = optax.apply_updates(jp, upd)
            p.grad = torch.from_numpy(gr)
            topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def test_ortho_grad_term_matches_jax(models):
    d = _port_d(models["d_vars"])
    ref = tree_to_torch(cheap_jit(lambda p: jstep.ortho_grad_term(p, 1e-3))(
        models["d_vars"]["params"]), discriminator_key_map(port_cfg()))
    got = tstep.ortho_grad_term(d, 1e-3)
    assert set(got) == {k for k, v in ref.items() if v.dim() >= 2}
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], rtol=1e-5, atol=1e-7, msg=k)
    g = _port_g(models["g_vars"])
    assert not any("shared" in k for k in tstep.ortho_grad_term(g, 1e-3, ("shared",)))


# --- discriminator -----------------------------------------------------------

def test_discriminator_converter_matches_export(models):
    got = discriminator_state_dict_from_jax(models["d_vars"], port_cfg())
    ref = export_discriminator_state_dict(models["d_vars"], JCFG)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    d = tbiggan.Discriminator(port_cfg(), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    assert set(d.state_dict()) == set(got)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_forward_matches_jax(models, train):
    """Eval, and train mode, where every layer also advances its u/sv."""
    x, feats = models["batch"]["x"][0], models["batch"]["feats"][0]
    apply = cheap_jit(lambda v, x, f: models["d"].apply(
        v, x, None, f, train=train, mutable=["sn"] if train else False))
    out = apply(models["d_vars"], jnp.asarray(x), jnp.asarray(feats))
    ref, mut = out if train else (out, None)
    d = _port_d(models["d_vars"]).train(train)
    with torch.no_grad():
        got = d(_nchw(x), None, torch.from_numpy(feats))
    assert got.shape == (MB, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    if train:
        new = discriminator_state_dict_from_jax(
            {"params": models["d_vars"]["params"], **mut}, port_cfg())
        for k, v in d.state_dict().items():
            if k.endswith((".u0", ".sv0")):
                np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_unported_discriminator_options_raise():
    """The class heads and DiffAugment are ported (``test_torch_port_
    classcond.py``, ``test_torch_port_train_cc.py``), and so is the
    BigGAN-deep backbone (``test_torch_port_biggan_deep.py``); what still
    raises in the BigGAN training path is data parallelism (ROADMAP.md A.9)
    and a model config of neither backbone."""
    from ic_gan_tpu_torch.cli.config import split_config
    from ic_gan_tpu_torch.models.biggan_deep import BigGANDeepConfig
    from ic_gan_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = port_cfg(class_cond=True)
    d = tbiggan.Discriminator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert d.embed.weight.shape == (cfg.n_classes, cfg.d_arch["out_channels"][-1] // 2)
    tstep.make_train_step(tstep.TrainConfig(DiffAugment="translation"), 35)
    with pytest.raises(NotImplementedError, match="A.9"):
        Trainer(port_cfg(), tstep.TrainConfig(), TrainerConfig(n_devices=2), None, device="cpu")
    with pytest.raises(NotImplementedError, match="not a BigGAN or BigGAN-deep"):
        Trainer(object(), tstep.TrainConfig(), TrainerConfig(), None, device="cpu")
    deep = split_config({"model": "BigGANdeep"})[0]
    assert isinstance(deep, BigGANDeepConfig)
    assert (deep.dim_z, deep.G_depth, deep.D_depth, deep.effective_dim_z) == (128, 2, 2, 128)


# --- one whole train step ------------------------------------------------------

def _jax_zs(rng, tcfg, mb, dim_z):
    """The z the JAX step draws (``step.py:207-208, 218-219, 244-245,
    256-258``): D's microbatches first, then G's."""
    zs = []
    for d_step in range(tcfg.num_D_steps):
        for acc_rng in jax.random.split(jax.random.fold_in(rng, d_step),
                                        tcfg.num_D_accumulations):
            z_rng, _ = jax.random.split(acc_rng)
            zs.append(jax.random.normal(z_rng, (mb, dim_z)) * jnp.sqrt(tcfg.z_var))
    for acc_rng in jax.random.split(jax.random.fold_in(rng, 1000),
                                    tcfg.num_G_accumulations):
        z_rng, _ = jax.random.split(acc_rng)
        zs.append(jax.random.normal(z_rng, (mb, dim_z)) * jnp.sqrt(tcfg.z_var))
    return [torch.from_numpy(np.array(z)) for z in zs]


# The step runs with a float64 interior on both sides (the JAX package's own
# equivalence check does the same, ``__graft_entry__.py:124-128``): in f32,
# reassociation noise amplified through batch norm at microbatch 4 and ReLU
# flips moves G's stem gradient by up to 3e-3 of its largest entry, which
# would hide real faults.  Both sides still take the attention logits and the
# D scores in f32, as the JAX layers do.  Raw gradients and EMA: max|Δ| ≤
# 1e-5·max|ref| + 1e-9 per tensor (the floor is for the biases before a batch
# norm, whose true gradient is 0 and whose computed one is ~1e-14 noise).
# Spectral-norm and batch-norm state: 3e-5·max|ref|; it is read after D's
# Adam update, which the Adam allowance below lets differ.
GRAD_REL, GRAD_ABS, STATE_REL = 1e-5, 1e-9, 3e-5


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _max_err(got, ref):
    return (got.detach() - ref).abs().max().item()


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(models, case):
    tkw = {**TCFG, **CASES[case]}
    jt, tt = jstep.TrainConfig(**tkw), tstep.TrainConfig(**tkw)
    dim_z = JCFG.effective_dim_z
    batch = {k: v.astype(np.float64) for k, v in models["batch"].items()}
    with jax.enable_x64(True):
        jcfg = JCFG.replace(dtype=jnp.float64)
        jg, jd = jbiggan.Generator(jcfg), jbiggan.Discriminator(jcfg)
        to64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jstate_ = jstate.GANTrainState.create(to64(models["g_vars"]), to64(models["d_vars"]),
                                              jt.g_optimizer(), jt.d_optimizer())
        jfn = jax.jit(jstep.make_train_step(jg.apply, jd.apply, jt, dim_z, debug_grads=True))
        rng = jax.random.PRNGKey(7)
        jnew, jm = jfn(jstate_, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        zs = _jax_zs(rng, jt, MB, dim_z)
        jnew, jm = _f64(jnew), _f64(jm)

    cfg = port_cfg(dtype=torch.float64)
    g, d = _port_g(models["g_vars"], torch.float64), _port_d(models["d_vars"], torch.float64)
    state = tstate.GANTrainState.create(g, d, tt.g_optimizer(), tt.d_optimizer())
    tbatch = dict(x=torch.stack([_nchw(x) for x in batch["x"]]),
                  feats=torch.from_numpy(batch["feats"]),
                  gen_feats=torch.from_numpy(batch["gen_feats"]))
    state, tm = tstep.make_train_step(tt, dim_z, debug_grads=True)(state, tbatch, zs=zs)
    assert state.step == 1 and zs[0].dtype == torch.float64

    for k in ("D_loss_real", "D_loss_fake", "G_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)
    for k in ("D_grad_nonfinite", "G_grad_nonfinite"):
        assert tm[k].item() == float(jm[k]) == 0.0

    gmap, dmap = generator_key_map(cfg), discriminator_key_map(cfg)
    for which, kmap in (("d_grads", dmap), ("g_grads", gmap)):
        ref = tree_to_torch(jm[which], kmap)
        assert set(tm[which]) == set(ref)
        for k, v in ref.items():
            bar = GRAD_REL * v.abs().max().item() + GRAD_ABS
            assert _max_err(tm[which][k], v) <= bar, f"{which} {k}"
    # The attention gradients are real: gamma is 0.5, so θ's is not zero.
    assert tm["d_grads"]["blocks.0.1.theta.weight"].abs().max() > 1e-3
    assert tm["g_grads"]["blocks.1.1.theta.weight"].abs().max() > 1e-3

    # SN u/sv of both networks and G's BN running statistics.
    ref_g = generator_state_dict_from_jax({"params": jnew.g_params, **jnew.g_state}, cfg)
    ref_d = discriminator_state_dict_from_jax({"params": jnew.d_params, **jnew.d_state}, cfg)
    n_state = 0
    for net, ref in ((g, ref_g), (d, ref_d)):
        for k, v in net.state_dict().items():
            if k.endswith((".u0", ".sv0", ".stored_mean", ".stored_var")):
                assert _max_err(v, ref[k]) <= STATE_REL * ref[k].abs().max().item(), k
                n_state += 1
    assert n_state > 50

    # EMA of parameters and buffers (ema_start 0: decay 0.9999 from step 0).
    ema_ref = generator_state_dict_from_jax(
        {"params": jnew.g_ema_params, **jnew.g_ema_state}, cfg)
    for k, v in state.g_ema.state_dict().items():
        assert _max_err(v, ema_ref[k]) <= GRAD_REL * ema_ref[k].abs().max().item() + GRAD_ABS, k

    # Parameters after Adam (see TCFG for the choice of ε).
    for net, params, kmap in ((g, jnew.g_params, gmap), (d, jnew.d_params, dmap)):
        ref = tree_to_torch(params, kmap)
        for k, p in net.named_parameters():
            assert _max_err(p, ref[k]) <= 1e-7, k
