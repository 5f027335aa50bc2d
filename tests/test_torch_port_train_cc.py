"""One whole class-and-instance-conditioned (cc_icgan) BigGAN step with
DiffAugment, the port's against the JAX package's, on the CPU.

A toy cc_icgan G and D (res 32, ``G_ch``/``D_ch`` 8, 10 classes, no
attention: ``test_torch_port_train.py`` holds the step with it, and the
JAX compile is the cost here) with variables from numpy; the same batch
(labels included), the z the JAX step draws and its DiffAugment draws
(``"color,translation,cutout"``, on the D phase's [fake, real] batch and
the G phase's fakes), replayed from its keys, go through
``make_train_step`` of both packages in a float64 interior.  Losses, raw gradients, spectral-norm and batch-norm
state, the EMA and the parameters after Adam are held to
``test_train_step_matches_jax``'s bars.  One JAX step compile.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.models import biggan as jbiggan
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
from ic_gan_tpu_torch.train import state as tstate
from ic_gan_tpu_torch.train import step as tstep
from test_torch_port_augment import jax_draws
from test_torch_port_classcond import _one_torch_thread, numpy_variables, port_cfg  # noqa: F401
from test_torch_port_train import GRAD_ABS, GRAD_REL, STATE_REL, TCFG, _f64, _max_err, _nchw

RES, MB, NC = 32, 4, 10
POLICY = "color,translation,cutout"
JCFG = jbiggan.BigGANConfig(resolution=RES, G_ch=8, D_ch=8, G_attn="0", D_attn="0",
                            dim_z=40, n_classes=NC, shared_dim=16, shared_dim_feat=16,
                            instance_sz=24, class_cond=True)
TKW = dict(TCFG, class_cond=True, DiffAugment=POLICY)


def _jax_draws(rng, tcfg):
    """The z and DiffAugment draws of the JAX step (``step.py:205-208,
    242-245``): per microbatch, D's first, ``z_rng, a_rng =
    split(acc_rng)``.  D augments 2·mb images in float64 (G's float32
    output joined by the reals), G its mb images in float32 (G's output
    type): the colour draws are taken in the batch's type."""
    dim_z = JCFG.effective_dim_z
    zs, augs = [], []

    def take(acc_rng, n_aug, dtype):
        z_rng, a_rng = jax.random.split(acc_rng)
        zs.append(torch.from_numpy(np.array(
            jax.random.normal(z_rng, (MB, dim_z)) * jnp.sqrt(tcfg.z_var))))
        augs.append(jax_draws(a_rng, POLICY, (n_aug, RES, RES, 3), dtype))

    for d_step in range(tcfg.num_D_steps):
        for acc_rng in jax.random.split(jax.random.fold_in(rng, d_step),
                                        tcfg.num_D_accumulations):
            take(acc_rng, 2 * MB, jnp.float64)
    for acc_rng in jax.random.split(jax.random.fold_in(rng, 1000), tcfg.num_G_accumulations):
        take(acc_rng, MB, jnp.float32)
    return zs, augs


def test_cc_icgan_diffaugment_step_matches_jax():
    rng = np.random.RandomState(0)
    nD, nG = TKW["num_D_accumulations"], TKW["num_G_accumulations"]
    batch = dict(
        x=rng.uniform(-1, 1, (nD, MB, RES, RES, 3)),
        label=rng.randint(0, NC, (nD, MB)).astype(np.int32),
        feats=rng.randn(nD, MB, JCFG.instance_sz),
        gen_label=rng.randint(0, NC, (nD + nG, MB)).astype(np.int32),
        gen_feats=rng.randn(nD + nG, MB, JCFG.instance_sz),
    )
    jg, jd = jbiggan.Generator(JCFG), jbiggan.Discriminator(JCFG)
    lab0, f0 = jnp.zeros((MB,), jnp.int32), jnp.zeros((MB, JCFG.instance_sz))
    g_vars = numpy_variables(jg, rng, jnp.zeros((MB, JCFG.effective_dim_z)), lab0, f0)
    d_vars = numpy_variables(jd, rng, jnp.zeros((MB, RES, RES, 3)), lab0, f0)
    jt, tt = jstep.TrainConfig(**TKW), tstep.TrainConfig(**TKW)
    dim_z = JCFG.effective_dim_z

    with jax.enable_x64(True):
        jcfg = JCFG.replace(dtype=jnp.float64)
        jg, jd = jbiggan.Generator(jcfg), jbiggan.Discriminator(jcfg)
        to64 = lambda tree: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), tree)
        jstate_ = jstate.GANTrainState.create(to64(g_vars), to64(d_vars),
                                              jt.g_optimizer(), jt.d_optimizer())
        jfn = jax.jit(jstep.make_train_step(jg.apply, jd.apply, jt, dim_z, debug_grads=True))
        key = jax.random.PRNGKey(7)
        jbatch = {k: jnp.asarray(v, jnp.int32 if "label" in k else jnp.float64)
                  for k, v in batch.items()}
        jnew, jm = jfn(jstate_, jbatch, key)
        zs, augs = _jax_draws(key, jt)
        jnew, jm = _f64(jnew), _f64(jm)

    cfg = port_cfg(JCFG, dtype=torch.float64)
    nets = {}
    for name, net_cls, variables, to_sd in (
            ("g", tbiggan.Generator, g_vars, generator_state_dict_from_jax),
            ("d", tbiggan.Discriminator, d_vars, discriminator_state_dict_from_jax)):
        net = torch.nn.utils.skip_init(net_cls, cfg, device="cpu")
        net.load_state_dict(to_sd(variables, port_cfg(JCFG)))
        nets[name] = net.to(torch.float64)
    g, d = nets["g"], nets["d"]
    state = tstate.GANTrainState.create(g, d, tt.g_optimizer(), tt.d_optimizer())
    tbatch = dict(x=torch.stack([_nchw(x) for x in batch["x"]]),
                  **{k: torch.from_numpy(batch[k]) for k in batch if k != "x"})
    assert tbatch["label"].dtype == torch.int32 and tbatch["feats"].dtype == torch.float64
    state, tm = tstep.make_train_step(tt, dim_z, debug_grads=True)(
        state, tbatch, zs=zs, aug_draws=augs)
    assert state.step == 1 and len(augs[0]) == 5 and augs[0][0].dtype == torch.float64
    assert augs[-1][0].dtype == torch.float32

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
    # The class heads and the class table take real gradients.
    for which, k in (("d_grads", "embed.weight"), ("g_grads", "shared.weight"),
                     ("d_grads", "linear_feat.weight")):
        assert tm[which][k].abs().max() > 1e-4, k

    ref_g = generator_state_dict_from_jax({"params": jnew.g_params, **jnew.g_state}, cfg)
    ref_d = discriminator_state_dict_from_jax({"params": jnew.d_params, **jnew.d_state}, cfg)
    n_state = 0
    for net, ref in ((g, ref_g), (d, ref_d)):
        for k, v in net.state_dict().items():
            if k.endswith((".u0", ".sv0", ".stored_mean", ".stored_var")):
                assert _max_err(v, ref[k]) <= STATE_REL * ref[k].abs().max().item(), k
                n_state += 1
    assert n_state > 40 and "embed.u0" in ref_d

    ema_ref = generator_state_dict_from_jax(
        {"params": jnew.g_ema_params, **jnew.g_ema_state}, cfg)
    for k, v in state.g_ema.state_dict().items():
        assert _max_err(v, ema_ref[k]) <= GRAD_REL * ema_ref[k].abs().max().item() + GRAD_ABS, k

    for net, params, kmap in ((g, jnew.g_params, gmap), (d, jnew.d_params, dmap)):
        ref = tree_to_torch(params, kmap)
        for k, p in net.named_parameters():
            assert _max_err(p, ref[k]) <= 1e-7, k
