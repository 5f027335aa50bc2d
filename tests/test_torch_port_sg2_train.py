"""The port's StyleGAN2-ADA training step against the JAX package, on the CPU.

One main step (``do_pl=False, do_r1=False``) of ``make_sg2_train_step`` in
each package, and one reg step (both on; in ``test_torch_port_sg2_train_reg.py``
with these helpers), from the same numpy variables, batch and draws, at the
toy geometry of ``tests/test_stylegan2_step.py`` cut to 8², without the ADA
pipe: it adds ~20 s to each JAX step's trace and compile here, which the
tier-1 run's time limit cannot spare.  The pipe itself, output and gradient,
is held to JAX's in ``test_torch_port_ada.py``, the second derivatives that
R1 takes through it (the row shift's and ``upfirdn2d``'s) in
``test_torch_port_sg2_ops.py`` and ``..._sg2_resample.py``, and the card's
steps with the pipe to the CPU's by ``chip_smoke.py``.  ``check_step``
still takes ``ada=True``.
Compared: losses, scores and penalties, the raw (scrubbed) gradients,
``w_avg``, ``pl_mean``, the ADA sums, the EMA and D's Adam-updated
parameters.

How the two are made to draw the same numbers:
- z, z_d, the style-mixing cutoffs and second latents, and the path-length
  noise: the test replays the JAX step's key splits and hands them to the
  port as ``draws``;
- ADA: ``debug_percentile`` 0.3 pins every transform on both sides (a 90°
  rotation, a translation, scalings, a rotation, colour);
- layer noise: ``noise_strength`` starts at 0, and G's learning rate is 0, so
  the noise stays 0 in the D phase too.  G's raw gradients, which is what the
  G phase computes, are compared; only ``noise_strength``'s are left out, as
  they are the random noise itself.  G's Adam is the same
  ``make_optimizer`` that ``test_torch_port_train.py`` holds to optax, with
  the lazy-regularization factors checked below.

Both sides run a float64 interior (``jax.enable_x64``; the port's modules
follow their inputs' type), as the BigGAN step test does: the composite
resampling kernels and ``upfirdn2d`` stay float32 inside, in both packages.
adam_eps is 1e-3, for the reason given in ``test_torch_port_train.py``.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.data.ada import AugmentPipe as JAugmentPipe
from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu.train import stylegan2_step as jstep
from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.io.convert import (
    stylegan2_state_dict_from_jax,
    stylegan2_variables_from_state_dict,
)
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.train import stylegan2_step as tstep
from test_torch_port_classcond import compile_async


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, RES = 4, 8
CFG = dict(img_resolution=RES, z_dim=8, c_dim=0, h_dim=12, w_dim=16, channel_base=512,
           channel_max=32, num_fp16_res=0, conv_clamp=None, num_mapping_layers=2,
           mbstd_group_size=2)
TCFG = dict(glr=0.0, adam_eps=1e-3)
DP = 0.3
# Raw gradients, EMA and w_avg: max|Δ| ≤ GRAD_REL·max|ref| + GRAD_ABS per
# tensor.  Both packages keep float32 inside a float64 step where they
# resample (ADA's wavelet up- and downsampling, G's image upsampling, the
# composite kernels of the up/down convs), each rounding its own way, and R1
# differentiates through D's twice: measured up to 4.9e-5 of a tensor's
# largest entry (D's b8.conv1.bias in the reg step), 1e-5 elsewhere.
GRAD_REL, GRAD_ABS = 1e-4, 1e-9


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def setup():
    """Variables from the port's own init (seeded), so that both packages
    start from weights at their init scale; the batch from numpy."""
    cfg = tsg2.StyleGAN2Config(**CFG)
    gen = torch.Generator().manual_seed(0)
    g = tsg2.Generator(cfg, device="cpu", generator=gen)
    d = tsg2.Discriminator(cfg, device="cpu", generator=gen)
    rng = np.random.RandomState(1)
    batch = dict(x=rng.uniform(-1, 1, (N, RES, RES, 3)),
                 h=rng.randn(N, CFG["h_dim"]), gen_h=rng.randn(N, CFG["h_dim"]))
    return dict(g_sd=g.state_dict(), d_sd=d.state_dict(), batch=batch,
                g_vars=stylegan2_variables_from_state_dict(g.state_dict()),
                d_vars=stylegan2_variables_from_state_dict(d.state_dict()))


def _jax_step(setup, do_reg, rng, ada):
    """The JAX step in float64, compiling (a future of the executable, and
    its arguments), and the draws it makes (``stylegan2_step.py: 188-199,
    216-222, 250-252, 285``), for the port."""
    with jax.enable_x64(True):
        jcfg = jsg2.StyleGAN2Config(**CFG)
        jg, jd = jsg2.Generator(jcfg), jsg2.Discriminator(jcfg)
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        tcfg = jstep.SG2TrainConfig(**TCFG)
        state = jstep.SG2TrainState.create(to64(setup["g_vars"]), to64(setup["d_vars"]), tcfg)
        pipe = JAugmentPipe.from_spec("bgc", geom_impl="fast")

        def aug(key, img, p):
            # debug_percentile's draws are read as Python floats: constants
            # are evaluated while tracing.
            with jax.ensure_compile_time_eval():
                return pipe(key, img, p, debug_percentile=DP)

        step = jstep.make_sg2_train_step(jg, jd, tcfg, CFG["z_dim"], do_pl=do_reg,
                                         do_r1=do_reg, augment_fn=aug if ada else None,
                                         debug_grads=True)
        args = (state, {k: jnp.asarray(v) for k, v in setup["batch"].items()}, rng)
        # XLA's cheap backend: the arithmetic is the same, the compile is
        # shorter; it runs while the caller runs the port's step.
        compiling = compile_async(step, *args)
        rngs = jax.random.split(rng, 8)
        num_ws = jsg2.SynthesisNetwork(CFG["w_dim"], RES, channel_base=512,
                                       channel_max=32).num_ws
        cutoffs, z2s = [], []
        for key in (rngs[1], rngs[7]):
            _, r_mix, r_cut, r_z2, _ = jax.random.split(key, 5)
            cut = jax.random.randint(r_cut, (), 1, num_ws)
            cutoffs.append(int(jnp.where(jax.random.uniform(r_mix) < 0.9, cut, num_ws)))
            z2s.append(np.asarray(jax.random.normal(r_z2, (N, CFG["z_dim"]))))
        draws = dict(z=jax.random.normal(rngs[0], (N, CFG["z_dim"])),
                     z_d=jax.random.normal(rngs[6], (N, CFG["z_dim"])),
                     cutoffs=np.asarray(cutoffs), z2s=np.stack(z2s))
        if do_reg:
            noise = jax.random.normal(rngs[5], (N // 2, RES, RES, 3))
            draws["pl_noise"] = np.transpose(np.asarray(noise), (0, 3, 1, 2))
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
        return compiling, args, draws


def _port_step(setup, do_reg, draws, ada):
    cfg = tsg2.StyleGAN2Config(**CFG)
    g, d = tsg2.Generator(cfg, device="cpu"), tsg2.Discriminator(cfg, device="cpu")
    g.load_state_dict(setup["g_sd"])
    d.load_state_dict(setup["d_sd"])
    g, d = g.double(), d.double()
    tcfg = tstep.SG2TrainConfig(**TCFG)
    state = tstep.SG2TrainState.create(g, d, tcfg)
    pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")
    aug = lambda img, p, gen: pipe(img, p, gen, debug_percentile=DP)  # noqa: E731
    step = tstep.make_sg2_train_step(tcfg, CFG["z_dim"], do_pl=do_reg, do_r1=do_reg,
                                     debug_grads=True, augment_fn=aug if ada else None)
    b = setup["batch"]
    batch = dict(x=torch.from_numpy(np.ascontiguousarray(np.transpose(b["x"], (0, 3, 1, 2)))),
                 h=torch.from_numpy(b["h"]), gen_h=torch.from_numpy(b["gen_h"]))
    return step(state, batch, torch.Generator().manual_seed(2), draws=draws)


def _close(got, ref, what):
    got = got.detach().double()
    assert got.shape == ref.shape, what
    bar = GRAD_REL * ref.abs().max().item() + GRAD_ABS
    err = (got - ref).abs().max().item()
    assert err <= bar, f"{what}: max|Δ| {err:.3e} > {bar:.3e}"


def check_step(setup, do_reg, ada):
    """One step of each package from the same start; every comparison.  The
    JAX step compiles while the port's step runs."""
    compiling, args, draws = _jax_step(setup, do_reg, jax.random.PRNGKey(7), ada)
    state, tm = _port_step(setup, do_reg, draws, ada)
    with jax.enable_x64(True):
        jnew, jm = compiling.result()(*args)
    jnew, jm = _f64(jnew), _f64(jm)

    keys = ["G_loss", "fake_scores", "D_loss", "real_scores", "real_signs"]
    keys += ["pl_penalty", "r1_penalty"] if do_reg else []
    assert set(keys) | {"G_grad_nonfinite", "D_grad_nonfinite", "g_grads", "d_grads"} == \
        set(tm) == set(jm)
    for k in keys:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, atol=1e-12, err_msg=k)
    assert tm["G_grad_nonfinite"].item() == tm["D_grad_nonfinite"].item() == 0.0
    if do_reg:
        assert tm["r1_penalty"].item() > 0 and tm["pl_penalty"].item() > 0

    for which in ("g_grads", "d_grads"):
        ref = stylegan2_state_dict_from_jax({"params": jm[which]})
        assert set(tm[which]) == set(ref)
        for k, v in ref.items():
            if not k.endswith("noise_strength"):   # the random noise itself (docstring)
                _close(tm[which][k], v, f"{which} {k}")
    assert tm["g_grads"]["mapping.fc0.weight"].abs().max() > 0

    # w_avg, pl_mean, the ADA sums, the step counters.
    ref_g = stylegan2_state_dict_from_jax({"params": jnew.g_params, **jnew.g_state})
    _close(state.g.mapping.w_avg, ref_g["mapping.w_avg"], "w_avg")
    assert not torch.equal(state.g.mapping.w_avg, setup["g_sd"]["mapping.w_avg"].double())
    np.testing.assert_allclose(state.pl_mean.item(), float(jnew.pl_mean), rtol=1e-6)
    assert (state.pl_mean.item() != 0.0) == do_reg
    np.testing.assert_allclose(state.ada_sign_sum.item(), float(jnew.ada_sign_sum), atol=1e-12)
    assert state.ada_count.item() == float(jnew.ada_count) == N
    assert state.step == int(jnew.step) == 1 and state.cur_nimg == int(jnew.cur_nimg) == N

    # EMA of G's parameters and float state, and D after its Adam step.
    ema_ref = stylegan2_state_dict_from_jax({"params": jnew.g_ema_params, **jnew.g_ema_state})
    for k, v in state.g_ema.state_dict().items():
        _close(v, ema_ref[k], f"ema {k}")
    # Adam moves a parameter by lr·g/(|g| + ε) in its first step, whose slope
    # in g is at most lr/ε: the gradients' bar times that.
    ref_d = stylegan2_state_dict_from_jax({"params": jnew.d_params})
    ref_dg = stylegan2_state_dict_from_jax({"params": jm["d_grads"]})
    lr = tstep.SG2TrainConfig(**TCFG)._lazy(TCFG.get("dlr", 0.002), 16)[0]
    for k, p in state.d.named_parameters():
        bar = lr / TCFG["adam_eps"] * (GRAD_REL * ref_dg[k].abs().max().item() + GRAD_ABS)
        assert (p.detach() - ref_d[k]).abs().max().item() <= bar, k
        assert not torch.equal(p.detach(), setup["d_sd"][k].double()), k


def test_sg2_main_step_matches_jax(setup):
    check_step(setup, do_reg=False, ada=False)


def test_lazy_regularization_optimizers_match_optax():
    """Each optimizer's lr and β₂ carry the lazy-regularization factor
    interval/(interval+1) (ref training_loop.py:332-340): a few Adam steps
    against optax on the same gradients."""
    tcfg, jcfg = tstep.SG2TrainConfig(), jstep.SG2TrainConfig()
    rng = np.random.RandomState(3)
    for t_tx, j_tx in ((tcfg.g_optimizer(), jcfg.g_optimizer()),
                       (tcfg.d_optimizer(), jcfg.d_optimizer())):
        p0 = rng.randn(5, 4).astype(np.float32)
        jp, opt = jnp.asarray(p0), j_tx.init(jnp.asarray(p0))
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        topt = t_tx([p])
        for _ in range(3):
            gr = rng.randn(5, 4).astype(np.float32)
            upd, opt = j_tx.update(jnp.asarray(gr), opt, jp)
            jp = optax.apply_updates(jp, upd)
            p.grad = torch.from_numpy(gr)
            topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_freeze_d_mask_and_ada_update_match_jax(setup):
    d_params = setup["d_vars"]["params"]
    d = tsg2.Discriminator(tsg2.StyleGAN2Config(**CFG), device="cpu")
    for layers in (0, 2, 5):
        ref = stylegan2_state_dict_from_jax({"params": jax.tree.map(
            lambda m: np.asarray(m, np.float32), jstep.freeze_d_mask(d_params, layers))})
        got = tstep.freeze_d_mask(d, layers)
        assert got == {k: bool(v.item()) for k, v in ref.items()}, layers
    tcfg = tstep.SG2TrainConfig()
    for sign_sum, p0 in ((40.0, 0.0), (-40.0, 0.5), (-40.0, 0.001)):
        g = tsg2.Generator(tsg2.StyleGAN2Config(**CFG), device="cpu")
        state = tstep.SG2TrainState.create(g, d, tcfg)
        state.ada_p, state.ada_sign_sum, state.ada_count = (
            torch.tensor(p0), torch.tensor(sign_sum), torch.tensor(40.0))
        jstate = jstep.SG2TrainState.create(setup["g_vars"], setup["d_vars"],
                                            jstep.SG2TrainConfig())
        jstate = jstate.replace(ada_p=jnp.asarray(p0), ada_sign_sum=jnp.asarray(sign_sum),
                                ada_count=jnp.asarray(40.0))
        jnew = jstep.ada_update(jstate, jstep.SG2TrainConfig(), batch_size=16)
        state = tstep.ada_update(state, tcfg, batch_size=16)
        np.testing.assert_allclose(state.ada_p.item(), float(jnew.ada_p), rtol=1e-6)
        assert state.ada_count.item() == state.ada_sign_sum.item() == 0.0
