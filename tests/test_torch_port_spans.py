"""The port's spans (``utils/spans.py``), on the CPU at toy sizes: a no-op
with no profiler running, and under one, the ranges at the sampler, the
train steps and their phases, the loader, the ADA pipe and the
bias-activation backward."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.data.loader import normalize_batch
from ic_gan_tpu_torch.io.deploy import make_sampler
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.ops.bias_act import bias_act
from ic_gan_tpu_torch.train import step as tstep
from ic_gan_tpu_torch.train import stylegan2_step as tsg2step
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.utils import spans


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MB = 4
# The toy geometries of tests/test_torch_port_checkpoint.py, narrower.
BIGGAN = tbiggan.BigGANConfig(resolution=32, G_ch=4, D_ch=4, G_attn="16", D_attn="16",
                              dim_z=20, shared_dim_feat=8, shared_dim=8, instance_sz=16)
SG2 = tsg2.StyleGAN2Config(img_resolution=16, z_dim=8, c_dim=0, h_dim=12, w_dim=16,
                           channel_base=256, channel_max=16, num_fp16_res=0,
                           conv_clamp=None, num_mapping_layers=2, mbstd_group_size=2)


def _u8(n=MB, res=8):
    return np.random.RandomState(0).randint(0, 256, (n, 3, res, res)).astype(np.uint8)


def _sampler():
    g = tbiggan.Generator(BIGGAN, device="cpu", generator=torch.Generator().manual_seed(0))
    return make_sampler(g, batch_size=2, device="cpu")


def _request(n=3):
    gen = torch.Generator().manual_seed(1)
    return (torch.randn((n, BIGGAN.effective_dim_z), generator=gen),
            torch.randn((n, BIGGAN.instance_sz), generator=gen))


def _spans(prof, name):
    """``(start_ns, end_ns)`` of the profiler's host events called ``name``,
    in time order (read off the raw events: building ``prof.events()``
    takes seconds at these sizes)."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events() if e.name() == name)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_no_profiler_no_range(monkeypatch):
    """With no profiler, ``span`` is one shared no-op, and no layer opens a
    range: a sampler request, the loader and a bias-activation backward run
    with ``record_function`` unusable."""
    assert not torch.autograd._profiler_enabled()
    assert spans.span("sampler/call") is spans.span("phase/D")

    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sampler = _sampler()
    z, feats = _request()
    assert sampler(z, feats=feats, device_output=True).shape == (3, 32, 32, 3)
    assert normalize_batch(_u8(), device="cpu").dtype == torch.float32
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    bias_act(x, torch.zeros(3, requires_grad=True), act="lrelu").sum().backward()
    assert x.grad is not None


def test_sampler_call_and_loader_spans():
    """A request of three rows in batches of two (a padded tail) is one
    ``sampler/call``; a loader batch is one ``data/normalize_batch``."""
    sampler = _sampler()
    z, feats = _request()
    prof = _profiled(lambda: (sampler(z, feats=feats, device_output=True),
                              normalize_batch(_u8(), device="cpu")))
    assert len(_spans(prof, "sampler/call")) == 1
    assert len(_spans(prof, "data/normalize_batch")) == 1


def test_biggan_step_holds_its_phases_in_order():
    gen = torch.Generator().manual_seed(2)
    g = tbiggan.Generator(BIGGAN, device="cpu", generator=gen)
    d = tbiggan.Discriminator(BIGGAN, device="cpu", generator=gen)
    tcfg = tstep.TrainConfig(ema_start=0)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    rng = np.random.RandomState(1)
    batch = dict(x=torch.from_numpy(rng.uniform(-1, 1, (1, MB, 3, 32, 32)).astype(np.float32)),
                 feats=torch.randn(1, MB, BIGGAN.instance_sz, generator=gen),
                 gen_feats=torch.randn(2, MB, BIGGAN.instance_sz, generator=gen))
    step = tstep.make_train_step(tcfg, BIGGAN.effective_dim_z)
    prof = _profiled(lambda: step(state, batch, torch.Generator().manual_seed(3)))
    (outer,) = _spans(prof, "train_step")
    phases = [_spans(prof, f"phase/{p}") for p in ("D", "G", "ema")]
    assert [len(p) for p in phases] == [1, 1, 1]
    (d_span,), (g_span,), (ema_span,) = phases
    assert all(_inside(p, outer) for p in (d_span, g_span, ema_span))
    assert d_span[1] <= g_span[0] and g_span[1] <= ema_span[0]


def test_sg2_reg_step_holds_the_ada_pipe_and_bias_act_backward():
    """``main+pl+r1`` with a 'bgc' pipe: the step's span holds the pipe's
    calls (G phase fakes, D phase fakes and reals) and its phases; the
    bias-activation backward still opens ``bias_act_bwd``."""
    gen = torch.Generator().manual_seed(4)
    g = tsg2.Generator(SG2, device="cpu", generator=gen)
    d = tsg2.Discriminator(SG2, device="cpu", generator=gen)
    tcfg = tsg2step.SG2TrainConfig(G_reg_interval=2, D_reg_interval=2)
    state = tsg2step.SG2TrainState.create(g, d, tcfg)
    state.ada_p = torch.full((), 0.5)
    step = tsg2step.make_sg2_train_step(tcfg, SG2.z_dim, do_pl=True, do_r1=True,
                                        augment_fn=AugmentPipe.from_spec("bgc"))
    batch = dict(x=torch.rand(MB, 3, 16, 16, generator=gen) * 2 - 1,
                 h=torch.randn(MB, 12, generator=gen), gen_h=torch.randn(MB, 12, generator=gen))
    prof = _profiled(lambda: step(state, batch, torch.Generator().manual_seed(5)))
    (outer,) = _spans(prof, "sg2_step/main+pl+r1")
    pipes = _spans(prof, "data/ada_pipe")
    assert len(pipes) == 3 and all(_inside(p, outer) for p in pipes)
    (g_span,), (d_span,), (ema_span,) = (_spans(prof, f"phase/{p}") for p in ("G", "D", "ema"))
    assert g_span[1] <= d_span[0] and d_span[1] <= ema_span[0]
    assert _spans(prof, "bias_act_bwd")
