"""The port's CUDA kernels (B1–B4) against their plain PyTorch versions, on
the card.

Marked ``cuda``; without a CUDA device every test skips (the kernels have no
CPU mode).  On a machine with a card, where the JAX package need not be
installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q
"""

import pytest
import torch

from ic_gan_tpu_torch.io.deploy import cast_params, make_sampler
from ic_gan_tpu_torch.models.biggan import BigGANConfig, Discriminator, Generator
from ic_gan_tpu_torch.models.layers import SelfAttention
from ic_gan_tpu_torch.ops.attention import (
    sagan_attention,
    sagan_attention_bwd,
    sagan_attention_bwd_ref,
    sagan_attention_fwd,
    sagan_attention_ref,
)
from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.models.stylegan2 import Discriminator as SG2Discriminator
from ic_gan_tpu_torch.models.stylegan2 import Generator as SG2Generator
from ic_gan_tpu_torch.models.stylegan2 import StyleGAN2Config
from ic_gan_tpu_torch.ops.bias_act import activation_funcs, bias_act, bias_act_fwd, bias_act_ref
from ic_gan_tpu_torch.ops.row_shift import row_shift, row_shift_fwd, row_shift_ref
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
from ic_gan_tpu_torch.train.stylegan2_step import SG2TrainConfig, SG2TrainState, make_sg2_train_step

pytestmark = pytest.mark.cuda
ACTS = list(activation_funcs)


@pytest.fixture(autouse=True)
def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _inputs(shape, dtype, seed=0):
    # g ~ N(0, 0.25) keeps outputs under 4, where one bf16 ulp is under 3e-2.
    n, lq, lk, d, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, p, g = (torch.randn(s, generator=gen, device="cuda")
               for s in ((n, lq, d), (n, lk, d), (n, lk, dv)))
    return t.to(dtype), p.to(dtype), (0.5 * g).to(dtype)


@pytest.mark.parametrize("shape", [
    (2, 256, 128, 8, 16),        # the CPU tests' shape
    (2, 4096, 1024, 48, 192),    # the 256² G's attention
    (2, 4096, 1024, 24, 96),     # the 128² G's widths
    (4, 1000, 250, 48, 192),     # ragged query and key tiles
    (1, 77, 19, 128, 256),       # the widest d and dv the kernel takes
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_attention_kernel_matches_plain(shape, dtype, atol):
    args = _inputs(shape, dtype)
    before = sagan_attention_fwd.launches
    got = sagan_attention(*args)
    torch.cuda.synchronize()
    assert sagan_attention_fwd.launches == before + 1
    ref = sagan_attention_ref(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= atol


def test_attention_kernel_rejects_what_it_does_not_take():
    t, p, g = _inputs((1, 64, 16, 8, 16), torch.float32)
    with pytest.raises(ValueError):
        sagan_attention(t.half(), p.half(), g.half())
    with pytest.raises(ValueError):
        sagan_attention(t, p, g.transpose(1, 2).contiguous().transpose(1, 2))
    wide = torch.zeros(1, 64, 129, device="cuda")
    with pytest.raises(ValueError):
        sagan_attention(wide, torch.zeros(1, 16, 129, device="cuda"), g)
    with pytest.raises(ValueError):
        sagan_attention(t.cpu(), p, g)


def test_sampler_launches_the_kernel_once_per_batch():
    cfg = BigGANConfig(resolution=32, G_ch=16, G_attn="16", dim_z=40,
                       shared_dim_feat=32, instance_sz=64, dtype=torch.bfloat16)
    g = Generator(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    sampler = make_sampler(cast_params(g, torch.bfloat16), batch_size=4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn((7, cfg.effective_dim_z), generator=gen, device="cuda")
    feats = torch.randn((7, cfg.instance_sz), generator=gen, device="cuda")
    before = sagan_attention_fwd.launches
    out = sampler(z, feats=feats)
    assert sagan_attention_fwd.launches == before + 2
    assert out.shape == (7, 32, 32, 3) and (abs(out) <= 1).all()


BWD_SHAPES = [
    (2, 4096, 1024, 48, 192),    # the 256² G's attention, at N 2
    (2, 4096, 1024, 24, 96),     # the 256² D's attention, at N 2
    (4, 1000, 250, 48, 192),     # ragged query and key tiles
    (3, 77, 19, 8, 16),          # narrow and ragged
    (1, 77, 19, 128, 256),       # the widest d and dv the kernel takes
]


def _assert_grads_close(got, ref, dtype):
    """f32: the JAX bar atol 1e-4, relative to max(1, max|plain|): dφ and dg
    sum over thousands of queries, in another order than cuBLAS.  bf16: the
    JAX bar, atol 5e-2 and rtol 2e-2 (one bf16 ulp is ~0.4 %)."""
    for name, t, r in zip(("dtheta", "dphi", "dg"), got, ref):
        assert t.dtype == r.dtype == dtype and t.shape == r.shape, name
        t, r = t.float(), r.float()
        if dtype == torch.float32:
            assert (t - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), name
        else:
            torch.testing.assert_close(t, r, atol=5e-2, rtol=2e-2, msg=name)


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_matches_plain(shape, dtype):
    args = _inputs(shape, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(args[0].shape[:2] + (shape[4],), generator=gen, device="cuda").to(dtype)
    before = sagan_attention_bwd.launches
    got = sagan_attention_bwd(*args, do)
    torch.cuda.synchronize()
    assert sagan_attention_bwd.launches == before + 1
    _assert_grads_close(got, sagan_attention_bwd_ref(*args, do), dtype)


def test_attention_bwd_kernel_rejects_what_it_does_not_take():
    t, p, g = _inputs((1, 64, 16, 8, 16), torch.float32)
    do = torch.zeros(1, 64, 16, device="cuda")
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.half())
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do[:, :32])
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.cpu())
    wide = torch.zeros(1, 16, 257, device="cuda")
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, wide, torch.zeros(1, 64, 257, device="cuda"))


def test_function_backward_launches_the_kernel():
    args = [a.requires_grad_(True) for a in _inputs((2, 256, 64, 8, 16), torch.float32)]
    before = (sagan_attention_fwd.launches, sagan_attention_bwd.launches)
    out = sagan_attention(*args)
    do = torch.randn_like(out)
    out.backward(do)
    torch.cuda.synchronize()
    assert (sagan_attention_fwd.launches, sagan_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = sagan_attention_bwd_ref(*[a.detach() for a in args], do)
    _assert_grads_close([a.grad for a in args], ref, torch.float32)


def test_toy_train_step_launches_both_kernels_and_trains():
    cfg = BigGANConfig(resolution=32, G_ch=16, D_ch=16, G_attn="16", D_attn="16", dim_z=40,
                       shared_dim_feat=32, instance_sz=64, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g, d = Generator(cfg, generator=gen), Discriminator(cfg, generator=gen)
    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, SelfAttention):
            m.gamma.data.fill_(0.5)
    n_attn = sum(isinstance(m, SelfAttention) for m in g.modules()), \
        sum(isinstance(m, SelfAttention) for m in d.modules())
    tcfg = TrainConfig(ema_start=0)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    before = [p.detach().clone() for p in list(g.parameters()) + list(d.parameters())]
    batch = dict(x=torch.rand((1, 4, 3, 32, 32), generator=gen, device="cuda") * 2 - 1,
                 feats=torch.randn((1, 4, 64), generator=gen, device="cuda"),
                 gen_feats=torch.randn((2, 4, 64), generator=gen, device="cuda"))
    fwd, bwd = sagan_attention_fwd.launches, sagan_attention_bwd.launches
    state, metrics = make_train_step(tcfg, cfg.effective_dim_z)(state, batch, gen)
    torch.cuda.synchronize()
    # B1: G and D in each phase; B2: D in the D phase, D and G in the G phase.
    assert sagan_attention_fwd.launches - fwd == 2 * (n_attn[0] + n_attn[1])
    assert sagan_attention_bwd.launches - bwd == 2 * n_attn[1] + n_attn[0]
    assert all(torch.isfinite(v).all() for v in metrics.values())
    after = list(g.parameters()) + list(d.parameters())
    assert all(not torch.equal(a, b) for a, b in zip(after, before) if a.dim() >= 2)


# --- kernels B3 (row shift) and B4 (bias-activation), and the StyleGAN2 step ---------

def _row_case(rows, L, lo, hi, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, L), generator=gen, device="cuda").to(dtype)
    return x, lo + (hi - lo) * torch.rand((rows,), generator=gen, device="cuda")


@pytest.mark.parametrize("rows,L,l_out,lo,hi", [
    (2 * 3 * 72, 144, 72, -10.0, 82.0),      # a shear pass (l_out < L)
    (2 * 3 * 72, 72, 144, -82.0, 10.0),      # its adjoint (l_out > L)
    (1001, 333, 517, -700.0, 700.0),         # rows beyond both ends of the frame
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_shift_kernel_matches_plain(rows, L, l_out, lo, hi, dtype):
    """f32 1e-6 (tests/test_row_shift.py:26); bf16 atol and rtol 2e-2 (:106)."""
    x, off = _row_case(rows, L, lo, hi, dtype)
    before = row_shift_fwd.launches
    got = row_shift_fwd(x, off, l_out)
    torch.cuda.synchronize()
    assert row_shift_fwd.launches == before + 1
    ref = row_shift_ref(x, off, l_out)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-6
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_row_shift_function_to_second_order_and_integer_shifts():
    """The backward launches the kernel again (order 1), the double backward
    once more (order 2); against autograd of the plain version, 1e-6 and
    1e-5 (tests/test_row_shift.py:53-56).  Integer shifts are exact."""
    x, off = _row_case(512, 100, -60.0, 160.0, torch.float32, seed=1)
    before = dict(row_shift_fwd.launches_by_order)
    out = []
    for fn in (row_shift, row_shift_ref):
        xx = x.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad(torch.sin(fn(xx, off, 50)).sum(), xx, create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xx)
        out.append((g1.detach(), g2))
    after = row_shift_fwd.launches_by_order
    # Order 1 twice: the first gradient, and again inside the second, through
    # sin's derivative; order 2 once: the adjoint of the adjoint.
    assert [after[k] - before.get(k, 0) for k in (0, 1, 2)] == [1, 2, 1]
    assert (out[0][0] - out[1][0]).abs().max().item() <= 1e-6
    assert (out[0][1] - out[1][1]).abs().max().item() <= 1e-5
    xi, off_i = x, torch.round(off)
    assert torch.equal(row_shift(xi, off_i, 100), row_shift_ref(xi, off_i, 100))


def test_row_shift_kernel_rejects_what_it_does_not_take():
    x, off = _row_case(4, 16, -2.0, 2.0, torch.float32)
    with pytest.raises(ValueError):
        row_shift_fwd(x.half(), off)
    with pytest.raises(ValueError):
        row_shift_fwd(x, off.double())
    with pytest.raises(ValueError):
        row_shift_fwd(x.t(), torch.zeros(16, device="cuda"))
    with pytest.raises(ValueError):
        row_shift_fwd(x, off.cpu())


@pytest.mark.parametrize("shape", [(16, 512), (4, 64, 32, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_kernel_matches_plain(shape, dtype):
    """Every activation, bias or none, clamp or none.  f32 1e-6 of
    max(1, max|plain|) (tests/test_pallas_bias_act.py:23); bf16 atol and
    rtol 2e-2: the plain version rounds after each step, the kernel once."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    b = torch.randn((shape[1],), generator=gen, device="cuda").to(dtype)
    for act in ACTS:
        for bias in (b, None):
            for clamp in (None, 1.0):
                before = bias_act_fwd.launches
                got = bias_act_fwd(x, bias, 1, act, None, None, clamp)
                torch.cuda.synchronize()
                assert bias_act_fwd.launches == before + 1
                ref = bias_act_ref(x, bias, 1, act, None, None, clamp)
                assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
                if dtype == torch.float32:
                    bar = 1e-6 * max(1.0, ref.abs().max().item())
                    assert (got - ref).abs().max().item() <= bar, (act, clamp)
                else:
                    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_function_to_second_order(act):
    """BiasAct (kernel forward, torch backward) against autograd of the
    plain version: 1e-5 first order, 1e-4 second (test_pallas_bias_act.py:
    55, 68), each of max(1, max|plain|); the backward launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 64, 8, 8), generator=gen, device="cuda")
    b = torch.randn((64,), generator=gen, device="cuda")
    clamp = 1.0 if act in ("lrelu", "relu", "swish") else None
    out = []
    for fn in (bias_act, bias_act_ref):
        xx, bb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = bias_act_fwd.launches
        y = fn(xx, bb, 1, act, None, None, clamp)
        gx, gb = torch.autograd.grad(y.square().sum(), (xx, bb), create_graph=True)
        (h,) = torch.autograd.grad(gx.square().sum(), xx)
        assert bias_act_fwd.launches - before == (1 if fn is bias_act else 0)
        out.append((gx.detach(), gb.detach(), h))
    for got, ref, bar in zip(out[0], out[1], (1e-5, 1e-5, 1e-4)):
        assert (got - ref).abs().max().item() <= bar * max(1.0, ref.abs().max().item())


def test_toy_sg2_steps_launch_b3_and_b4_and_train():
    """A main and a reg step of a toy StyleGAN2-ADA on the card: B3 in its
    forward, adjoint and double backward, B4 in G and D; finite losses,
    moving weights and a path-length mean off 0."""
    cfg = StyleGAN2Config(img_resolution=32, z_dim=16, h_dim=24, w_dim=16, channel_base=1024,
                          channel_max=64, num_fp16_res=2, num_mapping_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(4)
    g, d = SG2Generator(cfg, generator=gen), SG2Discriminator(cfg, generator=gen)
    tcfg = SG2TrainConfig()
    state = SG2TrainState.create(g, d, tcfg)
    pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")
    batch = dict(x=torch.rand((4, 3, 32, 32), generator=gen, device="cuda") * 2 - 1,
                 h=torch.randn((4, 24), generator=gen, device="cuda"),
                 gen_h=torch.randn((4, 24), generator=gen, device="cuda"))
    w0 = g.synthesis.b32.conv1.weight.detach().clone()
    for reg in (False, True):
        b3 = dict(row_shift_fwd.launches_by_order)
        b4 = bias_act_fwd.launches
        state, metrics = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg,
                                             augment_fn=pipe)(state, batch, gen)
        torch.cuda.synchronize()
        orders = {k: v - b3.get(k, 0) for k, v in row_shift_fwd.launches_by_order.items()
                  if v != b3.get(k, 0)}
        assert orders == ({0: 6, 1: 4, 2: 2} if reg else {0: 6, 1: 2})
        assert bias_act_fwd.launches > b4
        assert all(torch.isfinite(v).all() for v in metrics.values())
    assert state.pl_mean.item() != 0.0 and not torch.equal(g.synthesis.b32.conv1.weight, w0)
