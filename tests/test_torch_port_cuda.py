"""The port's CUDA kernels (B1–B4) against their plain PyTorch versions, on
the card.

Marked ``cuda``; without a CUDA device every test skips (the kernels have no
CPU mode).  On a machine with a card, where the JAX package need not be
installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q
"""

import copy

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
from ic_gan_tpu_torch.ops import bias_act as ba
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
    (2, 4096, 1024, 64, 256),    # BigGAN-deep's 256² attention (512 channels)
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
    (2, 4096, 1024, 64, 256),    # BigGAN-deep's 256² attention (512 channels)
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


def _bwd_inputs(shape, dtype):
    """θ, φ, g, do and the plain forward's log-sum-exp."""
    args = _inputs(shape, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(args[0].shape[:2] + (shape[4],), generator=gen, device="cuda").to(dtype)
    _, lse = sagan_attention_ref(*args, return_lse=True)
    return (*args, do), lse


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_kernel_matches_plain(shape, dtype):
    args, lse = _bwd_inputs(shape, dtype)
    before = sagan_attention_bwd.launches
    got = sagan_attention_bwd(*args, lse)
    torch.cuda.synchronize()
    assert sagan_attention_bwd.launches == before + 1
    _assert_grads_close(got, sagan_attention_bwd_ref(*args), dtype)


# The shapes of the TFHub BigGAN-256's attention at 128² (bf16, as its
# deployment sampler calls it; the plain version holds 256 MiB of f32 logits
# a sample) and of the CLIP-guided search's f32 G at its population of 50,
# forward and backward.
@pytest.mark.parametrize("shape,dtype,atol,backward", [
    ((2, 16384, 4096, 24, 96), torch.bfloat16, 3e-2, False),
    ((50, 4096, 1024, 48, 192), torch.float32, 2e-5, True),
])
def test_attention_kernels_at_the_tfhub_and_search_shapes(shape, dtype, atol, backward):
    args = _inputs(shape, dtype)
    before = sagan_attention_fwd.launches
    with torch.inference_mode():
        got = sagan_attention(*args)
    torch.cuda.synchronize()
    assert sagan_attention_fwd.launches == before + 1
    ref = sagan_attention_ref(*args)
    assert got.dtype == ref.dtype and (got.float() - ref.float()).abs().max().item() <= atol
    del got, ref
    if backward:
        args, lse = _bwd_inputs(shape, dtype)
        before = sagan_attention_bwd.launches
        got = sagan_attention_bwd(*args, lse)
        torch.cuda.synchronize()
        assert sagan_attention_bwd.launches == before + 1
        _assert_grads_close(got, sagan_attention_bwd_ref(*args), dtype)


# bf16 on the tensor cores: d 24 and dv 96 (k-dimension padded to 32), d and
# dv off the 16-byte rows (d % 8 != 0: the element-wise load path), ragged
# Lq and Lk.
TC_SHAPES = [
    (2, 4096, 1024, 24, 96),
    (2, 300, 70, 12, 20),
    (3, 1000, 250, 24, 96),
    (2, 77, 19, 5, 7),
]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_attention_bf16_tensor_core_cases(shape):
    args = _inputs(shape, torch.bfloat16)
    out, lse = sagan_attention_fwd(*args, return_lse=True)
    ref, ref_lse = sagan_attention_ref(*args, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    # Tensor-core f32 accumulation of the logits: atol 1e-5 + rtol 1e-6.
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)
    bargs, blse = _bwd_inputs(shape, torch.bfloat16)
    _assert_grads_close(sagan_attention_bwd(*bargs, blse), sagan_attention_bwd_ref(*bargs),
                        torch.bfloat16)


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_function_hands_lse_from_forward_to_backward_bf16(shape):
    args = [a.requires_grad_(True) for a in _inputs(shape, torch.bfloat16)]
    before = (sagan_attention_fwd.launches, sagan_attention_bwd.launches)
    out = sagan_attention(*args)
    do = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                     device="cuda").to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert (sagan_attention_fwd.launches, sagan_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = sagan_attention_bwd_ref(*[a.detach() for a in args], do)
    _assert_grads_close([a.grad for a in args], ref, torch.bfloat16)


def test_attention_bwd_bf16_is_deterministic():
    # Two passes and no atomics: the same inputs give the same bits.
    args, lse = _bwd_inputs((2, 4096, 1024, 48, 192), torch.bfloat16)
    first = sagan_attention_bwd(*args, lse)
    second = sagan_attention_bwd(*args, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_attention_bwd_kernel_rejects_what_it_does_not_take():
    t, p, g = _inputs((1, 64, 16, 8, 16), torch.float32)
    do = torch.zeros(1, 64, 16, device="cuda")
    lse = torch.zeros(1, 64, device="cuda")
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.half(), lse)
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do[:, :32], lse)
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.transpose(1, 2).contiguous().transpose(1, 2), lse)
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do.cpu(), lse)
    wide = torch.zeros(1, 16, 257, device="cuda")
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, wide, torch.zeros(1, 64, 257, device="cuda"), lse)
    with pytest.raises(ValueError):  # lse must be (N, Lq) f32 on the same device
        sagan_attention_bwd(t, p, g, do, lse.double())
    with pytest.raises(ValueError):
        sagan_attention_bwd(t, p, g, do, lse[:, :32])


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
    """BiasAct (kernel forward, BiasActGrad's kernel backward) against
    autograd of the plain version: 1e-5 first order, 1e-4 second
    (test_pallas_bias_act.py:55, 68), each of max(1, max|plain|).  The
    forward launches once; the backward kernel three times: the first
    gradient, then in the second BiasActGrad's own backward (linear in gy)
    and BiasAct's backward again (gy = 2y depends on x)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 64, 8, 8), generator=gen, device="cuda")
    b = torch.randn((64,), generator=gen, device="cuda")
    clamp = 1.0 if act in ("lrelu", "relu", "swish") else None
    out = []
    for fn in (bias_act, bias_act_ref):
        xx, bb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = bias_act_fwd.launches, ba.bias_act_bwd.launches
        y = fn(xx, bb, 1, act, None, None, clamp)
        gx, gb = torch.autograd.grad(y.square().sum(), (xx, bb), create_graph=True)
        (h,) = torch.autograd.grad(gx.square().sum(), xx)
        moved = (bias_act_fwd.launches - before[0], ba.bias_act_bwd.launches - before[1])
        assert moved == ((1, 3) if fn is bias_act else (0, 0))
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
        b4 = bias_act_fwd.launches, ba.bias_act_bwd.launches
        state, metrics = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg,
                                             augment_fn=pipe)(state, batch, gen)
        torch.cuda.synchronize()
        orders = {k: v - b3.get(k, 0) for k, v in row_shift_fwd.launches_by_order.items()
                  if v != b3.get(k, 0)}
        assert orders == ({0: 6, 1: 4, 2: 2} if reg else {0: 6, 1: 2})
        assert bias_act_fwd.launches > b4[0] and ba.bias_act_bwd.launches > b4[1]
        assert all(torch.isfinite(v).all() for v in metrics.values())
    assert state.pl_mean.item() != 0.0 and not torch.equal(g.synthesis.b32.conv1.weight, w0)


# --- B3 and B4 after their redesign: the vector paths' edges ------------------------

def _storage_offset_view(shape, dtype, gen):
    """A contiguous view one element into its storage: not 16-byte aligned."""
    n = 1
    for d in shape:
        n *= d
    base = torch.randn((n + 1,), generator=gen, device="cuda").to(dtype)
    return base[1:].view(shape)


# (name, x shape).  With a bias: FC with C 512 takes the kernel's row layout
# (the bias read as a vector); odd C over 4x4 planes (16 elements, a whole
# number of vectors) the plane layout; 3x3 and 5x5 planes, an FC layer of odd
# C and unaligned pointers its scalar path.  With no bias every aligned case
# takes the plane layout.  The empty tensor launches nothing.
B4_EDGES = [("fc C512", (16, 512)), ("3x3 planes", (4, 24, 3, 3)),
            ("5x5 planes", (4, 24, 5, 5)), ("odd C", (3, 7, 4, 4)), ("odd C fc", (5, 9)),
            ("storage offset 1", (2, 16, 4, 4)), ("empty", (0, 16, 4, 4))]


def _b4_bar_ok(got, ref_fn, x, gy_or_none, b, act, clamp):
    """f32: max|Δ| ≤ bar·max(1, max|plain|) (forward 1e-6, backward 1e-5);
    bf16: atol and rtol 2e-2 against the plain version evaluated in f32 on
    the upcast inputs and rounded once (the bf16 plain version rounds after
    every step, so elements at the clamp's edge may flip against it)."""
    if x.dtype == torch.float32:
        ref = ref_fn(x, gy_or_none, b)
        bar = (1e-6 if gy_or_none is None else 1e-5) * max(1.0, ref.abs().max().item()
                                                          if ref.numel() else 1.0)
        return got.dtype == ref.dtype and ((got - ref).abs().max().item() if ref.numel()
                                           else 0.0) <= bar
    up = lambda t: None if t is None else t.float()  # noqa: E731
    ref = ref_fn(up(x), up(gy_or_none), up(b)).bfloat16().float()
    return got.dtype == torch.bfloat16 and bool(
        ((got.float() - ref).abs() <= 2e-2 + 2e-2 * ref.abs()).all())


@pytest.mark.parametrize("name,shape", B4_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_kernels_at_vector_path_edges(name, shape, dtype):
    """Both B4 kernels against their plain versions at the edges of the
    vector path, every activation, bias or none, clamp or none; each launch
    counted (none for the empty tensor)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    if name == "storage offset 1":
        x = _storage_offset_view(shape, dtype, gen)
        b = _storage_offset_view((shape[1],), dtype, gen)
        assert x.data_ptr() % 16 and b.data_ptr() % 16 and x.is_contiguous()
    else:
        x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
        b = torch.randn((shape[1],), generator=gen, device="cuda").to(dtype)
    gy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    launches = 0 if x.numel() == 0 else 1
    for act in ACTS:
        for bias in (b, None):
            for clamp in (None, 1.0):
                before = bias_act_fwd.launches, ba.bias_act_bwd.launches
                y = bias_act_fwd(x, bias, 1, act, None, None, clamp)
                gx = ba.bias_act_bwd(gy, x, bias, 1, act, None, None, clamp)
                torch.cuda.synchronize()
                assert (bias_act_fwd.launches - before[0],
                        ba.bias_act_bwd.launches - before[1]) == (launches, launches)
                assert y.shape == gx.shape == x.shape
                assert _b4_bar_ok(y, lambda x_, _, b_: bias_act_ref(
                    x_, b_, 1, act, None, None, clamp), x, None, bias, act, clamp), (act, clamp)
                assert _b4_bar_ok(gx, lambda x_, g_, b_: ba._grad_x_ref(
                    g_, x_, b_, 1, act, None, None, clamp), x, gy, bias, act, clamp), (act, clamp)


def test_bias_act_bwd_is_deterministic_and_counters_reset():
    """Two runs of the backward (kernel gx, torch's bias sum gb) give the
    same bits: no atomics.  ``reset_launches`` zeroes both counters."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (30 * torch.randn((4, 64, 64, 64), generator=gen, device="cuda")).bfloat16()
    b = torch.randn((64,), generator=gen, device="cuda").bfloat16().requires_grad_(True)
    gy = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        runs.append(torch.autograd.grad(bias_act(xx, b, 1, "lrelu", clamp=256.0), (xx, b), gy))
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    assert ba.bias_act_bwd.launches > 0
    ba.reset_launches()
    assert bias_act_fwd.launches == ba.bias_act_bwd.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,L,l_out", [
    (512, 144, 70),        # l_out % 4 != 0: the scalar path's stores
    (512, 146, 72),        # L % 4 != 0: the scalar path's loads
    (38016, 792, 1584),    # the adjoint shape of the StyleGAN2 path
    (640, 1584, 792),      # the path's row length
])
def test_row_shift_kernel_shift_residues_and_frame(rows, L, l_out, dtype):
    """B3 against its plain version with shifts of every residue mod 8 (so
    mod 4), fractional and integer, rows partly and wholly out of frame at
    both ends, and a NaN offset (a NaN row on both sides, as the JAX package
    gives; a finite offset out of frame gives zeros); bars as above."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((rows, L), generator=gen, device="cuda").to(dtype)
    off = (torch.rand((rows,), generator=gen, device="cuda") * (L + l_out + 40)
           - (l_out + 20))
    off[:64] = torch.arange(64, device="cuda") - 32 + torch.where(
        torch.arange(64, device="cuda") < 32, 0.0, 0.375)
    off[64:68] = torch.tensor([float("nan"), -(l_out + 1.5), L + 0.5, float(L)], device="cuda")
    before = row_shift_fwd.launches
    got = row_shift_fwd(x, off, l_out)
    torch.cuda.synchronize()
    assert row_shift_fwd.launches == before + 1
    ref = row_shift_ref(x, off, l_out)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    assert torch.isnan(got[64]).all() and torch.isnan(ref[64]).all()
    assert not got[65].any() and not ref[65].any()
    assert torch.isfinite(got[:64]).all() and torch.isfinite(got[65:]).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0, equal_nan=True)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2,
                                   equal_nan=True)


# --- the StyleGAN2-ADA training loop and its checkpoints ------------------------------

SG2_TOY = dict(img_resolution=32, z_dim=32, c_dim=0, h_dim=64, w_dim=32, channel_base=1024,
               channel_max=64, num_fp16_res=2, num_mapping_layers=2)


class _CardDataset:
    """Images and features on the card from a seed, sampled like HDF5Dataset."""

    def __init__(self, n=16, res=32, h_dim=64):
        gen = torch.Generator(device="cuda").manual_seed(3)
        self.x = torch.rand((n, 3, res, res), generator=gen, device="cuda") * 2 - 1
        self.h = torch.randn((n, h_dim), generator=gen, device="cuda")
        self.idx = torch.Generator().manual_seed(4)

    def _i(self, n):
        return torch.randint(0, self.x.shape[0], (n,), generator=self.idx).cuda()

    def sample_batch(self, n):
        from ic_gan_tpu_torch.data.datasets import Batch
        return Batch(self.x[self._i(n)], None, self.h[self._i(n)], None)

    def sample_conditioning_instance_balance(self, n):
        return None, self.h[self._i(n)]


def _toy_trainer(tmp_path, **loop):
    from ic_gan_tpu_torch.train.stylegan2_trainer import SG2LoopConfig, SG2Trainer
    return SG2Trainer(
        StyleGAN2Config(**SG2_TOY), SG2TrainConfig(G_reg_interval=2, D_reg_interval=3,
                                                   ada_interval=2),
        SG2LoopConfig(run_dir=str(tmp_path), batch_size=4, kimg_per_tick=0.008,
                      snapshot_ticks=1, augment_p_init=0.5, **loop),
        _CardDataset(), device="cuda")


def test_toy_sg2_loop_launches_b3_and_b4_in_every_variant(tmp_path):
    """``SG2Trainer.run(max_steps=4)``: steps 0-3 run pl+r1, main, pl, r1,
    each launching B3 and both B4 kernels; stats and a snapshot written."""
    import json
    import os

    tr = _toy_trainer(tmp_path)
    ran = []

    def counting(key, fn):
        def step(state, batch, generator):
            before = (row_shift_fwd.launches, bias_act_fwd.launches, ba.bias_act_bwd.launches)
            out = fn(state, batch, generator)
            after = (row_shift_fwd.launches, bias_act_fwd.launches, ba.bias_act_bwd.launches)
            ran.append((key, tuple(a - b for a, b in zip(after, before))))
            return out
        return step

    tr.steps = {k: counting(k, fn) for k, fn in tr.steps.items()}
    tr.run(max_steps=4)
    torch.cuda.synchronize()
    assert [k for k, _ in ran] == [(True, True), (False, False), (True, False), (False, True)]
    assert all(min(n) > 0 for _, n in ran), ran
    with open(os.path.join(tr.run_dir, "stats.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["kimg"] for r in recs] == [0.008, 0.016]
    assert all(torch.isfinite(torch.tensor([v for k, v in r.items()])).all() for r in recs)
    assert os.path.exists(os.path.join(tr.run_dir, "network-snapshot", "state.pt"))


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A snapshot of a card state loads into another trainer's state on the
    card bit for bit, Adam moments and 0-d tensors included, all on CUDA."""
    from ic_gan_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    tr = _toy_trainer(tmp_path / "a")
    tr.run(max_steps=2)
    tr.state.ada_p = tr.state.ada_p + 0.125
    save_checkpoint(str(tmp_path), "snap", tr.state, config={"kimg": 0.008})
    other = _toy_trainer(tmp_path / "b", seed=9)
    loaded, config = load_checkpoint(str(tmp_path), "snap", other.state)
    assert config == {"kimg": 0.008} and loaded.step == 2 and loaded.cur_nimg == 8
    for key in ("g", "d", "g_ema"):
        a, b = getattr(tr.state, key).state_dict(), getattr(loaded, key).state_dict()
        assert all(b[k].is_cuda and torch.equal(v, b[k]) for k, v in a.items()), key
    for key in ("g_opt", "d_opt"):
        a, b = getattr(tr.state, key).state_dict(), getattr(loaded, key).state_dict()
        for i, st in a["state"].items():
            for name, v in st.items():
                assert torch.equal(v.cpu(), b["state"][i][name].cpu()), (key, i, name)
                if name != "step":
                    assert b["state"][i][name].is_cuda
    for key in ("pl_mean", "ada_p", "ada_sign_sum", "ada_count"):
        v = getattr(loaded, key)
        assert v.is_cuda and torch.equal(v, getattr(tr.state, key)), key


# --- the BigGAN training loop slice: cc_icgan, DiffAugment, the trainer -------------

def _cc_toy(device, seed=0):
    cfg = BigGANConfig(resolution=32, G_ch=16, D_ch=16, G_attn="16", D_attn="16", dim_z=40,
                       shared_dim=16, shared_dim_feat=32, instance_sz=64, class_cond=True,
                       n_classes=10)
    gen = torch.Generator(device=device).manual_seed(seed)
    g, d = Generator(cfg, device=device, generator=gen), Discriminator(cfg, device=device,
                                                                       generator=gen)
    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, SelfAttention):
            m.gamma.data.fill_(0.5)
    return cfg, g, d


def test_toy_cc_icgan_diffaugment_step_card_matches_cpu():
    """One f32 cc_icgan step with DiffAugment from the same weights, batch, z
    and augmentation draws on the card and on the CPU: losses 1e-4
    relative, raw gradients 1e-2 of each tensor's largest entry + 1e-5 of
    the network's (chip_smoke.py phase 8's bars)."""
    from ic_gan_tpu_torch.data.augment import augment_draws

    policy = "color,translation,cutout"
    tcfg = TrainConfig(ema_start=0, adam_eps=1e-3, class_cond=True, DiffAugment=policy)
    cfg, g_cpu, d_cpu = _cc_toy("cpu")
    gen = torch.Generator().manual_seed(1)
    mb = 4
    batch = dict(x=torch.rand((1, mb, 3, 32, 32), generator=gen) * 2 - 1,
                 label=torch.randint(0, 10, (1, mb), generator=gen),
                 feats=torch.randn((1, mb, 64), generator=gen),
                 gen_label=torch.randint(0, 10, (2, mb), generator=gen),
                 gen_feats=torch.randn((2, mb, 64), generator=gen))
    zs = [torch.randn((mb, cfg.effective_dim_z), generator=gen) for _ in range(2)]
    aug = [augment_draws(policy, torch.empty((n, 3, 32, 32)), gen) for n in (2 * mb, mb)]
    out = {}
    for dev in ("cpu", "cuda"):
        g = Generator(cfg, device=dev, generator=torch.Generator(device=dev))
        d = Discriminator(cfg, device=dev, generator=torch.Generator(device=dev))
        g.load_state_dict(g_cpu.state_dict())
        d.load_state_dict(d_cpu.state_dict())
        state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
        fwd, bwd = sagan_attention_fwd.launches, sagan_attention_bwd.launches
        _, m = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True)(
            state, {k: v.to(dev) for k, v in batch.items()}, zs=[z.to(dev) for z in zs],
            aug_draws=aug)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sagan_attention_fwd.launches > fwd and sagan_attention_bwd.launches > bwd
        out[dev] = m
    for k in ("D_loss_real", "D_loss_fake", "G_loss"):
        a, b = out["cuda"][k].item(), out["cpu"][k].item()
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), k
    for which in ("d_grads", "g_grads"):
        ref = out["cpu"][which]
        top = max(v.abs().max().item() for v in ref.values())
        for k, r in ref.items():
            err = (out["cuda"][which][k].cpu() - r).abs().max().item()
            assert err <= 1e-2 * r.abs().max().item() + 1e-5 * top, (which, k, err)
    assert out["cpu"]["d_grads"]["embed.weight"].abs().max() > 0


class _CardClassDataset:
    """Images, labels and features on the card, indices from ``rng``."""

    which_nn_balance = "instance_balance"

    def __init__(self, n=16, seed=0):
        import numpy as np

        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.images = torch.rand((n, 3, 32, 32), generator=gen, device="cuda") * 2 - 1
        self.labels = torch.randint(0, 10, (n,), generator=gen, device="cuda")
        self.feats = torch.randn((n, 64), generator=gen, device="cuda")
        self.rng = np.random.default_rng(seed)
        self.n = n

    def __len__(self):
        return self.n

    def _draw(self, k):
        return torch.as_tensor(self.rng.integers(0, self.n, k), device="cuda")

    def sample_batch(self, k, weights=None):
        from ic_gan_tpu_torch.data.datasets import Batch

        i = self._draw(k)
        return Batch(self.images[i], self.labels[i], self.feats[i], None)

    def sample_conditioning_instance_balance(self, k, weights=None):
        i = self._draw(k)
        return self.labels[i], self.feats[i]


def test_toy_biggan_loop_saves_and_resumes_on_the_card(tmp_path):
    """``Trainer.run``: two epochs of two cc_icgan + DiffAugment steps in
    bf16, B1 and B2 in every step; the snapshot resumes into a fresh
    trainer bit for bit, history and dataset RNG included."""
    from ic_gan_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = BigGANConfig(resolution=32, G_ch=16, D_ch=16, G_attn="16", D_attn="16", dim_z=40,
                       shared_dim=16, shared_dim_feat=32, instance_sz=64, class_cond=True,
                       n_classes=10, dtype=torch.bfloat16)
    tcfg = TrainConfig(ema_start=0, class_cond=True, DiffAugment="color,translation,cutout")
    lcfg = TrainerConfig(experiment_name="toy", weights_root=str(tmp_path / "w"),
                         logs_root=str(tmp_path / "l"), num_epochs=2, test_every=10,
                         num_save_copies=1, seed=3, batch_size=4, log_every=1,
                         sv_log_interval=1, enable_tb=False)
    tr = Trainer(cfg, tcfg, lcfg, _CardClassDataset(), device="cuda")
    per_step = []
    real = tr.step_fn

    def step(state, batch, generator):
        before = (sagan_attention_fwd.launches, sagan_attention_bwd.launches)
        out = real(state, batch, generator)
        per_step.append((sagan_attention_fwd.launches - before[0],
                         sagan_attention_bwd.launches - before[1]))
        return out

    tr.step_fn = step
    tr.run(steps_per_epoch=2)
    torch.cuda.synchronize()
    n_fwd = sum(isinstance(m, SelfAttention) for m in list(tr.g.modules()) + list(tr.d.modules()))
    assert len(per_step) == 4 and all(f == 2 * n_fwd and b > 0 for f, b in per_step), per_step
    assert tr.history["itr"] == 4 and tr.history["epoch"] == 2
    fresh = Trainer(cfg, tcfg, lcfg, _CardClassDataset(), device="cuda")
    fresh.resume()
    assert fresh.history == tr.history
    assert fresh.dataset.rng.bit_generator.state == tr.dataset.rng.bit_generator.state
    for key in ("g", "d", "g_ema"):
        a, b = getattr(tr.state, key).state_dict(), getattr(fresh.state, key).state_dict()
        assert all(b[k].is_cuda and torch.equal(v, b[k]) for k, v in a.items()), key
    assert fresh.state.step == 4


# --- the eval stack ------------------------------------------------------------------

def _inception(dtype, device, seed=0):
    from ic_gan_tpu_torch.models.inception import InceptionV3

    net = InceptionV3(dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(seed))
    return net.to(device).eval()


def test_inception_card_matches_cpu():
    """Random weights from a seed, 4 images at 64² resized to 299²: the card
    in f32 within 1e-3 of the largest pool entry of the CPU's; the bf16 mode
    on the card within JAX's drift bars (max 0.15, mean 0.02 of the mean
    |pool|) of the CPU's f32 and of the CPU's bf16."""
    x = torch.tanh(torch.randn((4, 3, 64, 64), generator=torch.Generator().manual_seed(1)))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for device in ("cpu", "cuda"):
            with torch.inference_mode():
                pool, logits = _inception(dtype, device)(x.to(device))
            assert pool.dtype == logits.dtype == torch.float32
            out[dtype, device] = pool.cpu()
    ref = out[torch.float32, "cpu"]
    assert (out[torch.float32, "cuda"] - ref).abs().max() <= 1e-3 * ref.abs().max()
    scale = ref.abs().mean()
    for other in (ref, out[torch.bfloat16, "cpu"]):
        d = (out[torch.bfloat16, "cuda"] - other).abs()
        assert d.max() <= 0.15 * scale and d.mean() <= 0.02 * scale


def _pools(n, dim, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn((n, dim), generator=gen)) * (torch.rand(dim, generator=gen) + 0.5)


def _reference(dim, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((dim, dim // 4), generator=gen, dtype=torch.float64)
    return (torch.randn(dim, generator=gen, dtype=torch.float64) * 0.1,
            a @ a.T / dim + 0.1 * torch.eye(dim, dtype=torch.float64))


def test_fid_tail_with_tf32_on_matches_cpu_and_restores_the_setting():
    """``fid_is_device`` with the caller's TF32 on: the card within 1e-4 of
    the CPU (the tail runs in full f32 whatever the caller set), Newton-
    Schulz on both (full rank), and TF32 still on afterwards."""
    from ic_gan_tpu_torch.eval.fid import fid_is_device, trace_sqrtm_product

    pools, logits = _pools(3000, 512, 2), torch.randn((3000, 100), generator=torch.Generator().manual_seed(3))
    mu, sigma = _reference(512, 4)
    torch.backends.cuda.matmul.allow_tf32 = True
    got = [float(v) for v in fid_is_device(pools.cuda(), logits.cuda(), mu, sigma)]
    assert torch.backends.cuda.matmul.allow_tf32
    want = [float(v) for v in fid_is_device(pools, logits, mu, sigma)]
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want)), (got, want)
    d0 = pools - pools.mean(0)
    s1 = d0.T @ d0 / (len(pools) - 1)
    assert not trace_sqrtm_product(s1.cuda(), sigma.float().cuda())[1]
    assert not trace_sqrtm_product(s1, sigma.float())[1]
    assert torch.backends.cuda.matmul.allow_tf32


def test_fid_eigenvalue_path_on_the_card():
    """Rank-deficient covariances (64 samples in 512 dimensions): Newton-
    Schulz goes non-finite on the card as on the CPU, and the eigenvalue
    path's FID agrees within 1e-4."""
    from ic_gan_tpu_torch.eval.fid import frechet_distance, trace_sqrtm_product

    p = _pools(64, 512, 5).double()
    mu1, s1 = p.mean(0), torch.cov(p.T)
    mu2, s2 = _reference(512, 6)
    assert trace_sqrtm_product(s1.float().cuda(), s2.float().cuda())[1]
    assert trace_sqrtm_product(s1.float(), s2.float())[1]
    got = frechet_distance(mu1, s1, mu2, s2, device="cuda")
    want = frechet_distance(mu1, s1, mu2, s2, device="cpu")
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_fused_eval_loop_launches_b1_a_batch_and_matches_cpu():
    """``evaluate_generator`` over ``make_fused_feature_fn`` of a toy f32 G
    with attention: one B1 launch a batch of 8 (the tail batch padded), and
    FID and IS within 1e-3 of the same loop on the CPU."""
    from ic_gan_tpu_torch.eval.pipeline import (
        InceptionEvaluator,
        evaluate_generator,
        make_fused_feature_fn,
    )

    cfg = BigGANConfig(resolution=32, G_ch=8, G_attn="16", dim_z=20, instance_sz=12)
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for m in g.modules():
        if isinstance(m, SelfAttention):
            m.gamma.data.fill_(0.5)
    mu, sigma = _reference(2048, 7)
    z = torch.randn((20, cfg.effective_dim_z), generator=torch.Generator().manual_seed(8))
    feats = torch.randn((20, 12), generator=torch.Generator().manual_seed(9))
    out = {}
    for device in ("cpu", "cuda"):
        sampler = make_sampler(copy.deepcopy(g), batch_size=8, device=device)
        evaluator = InceptionEvaluator(device=device)
        fused = make_fused_feature_fn(sampler, evaluator)
        pos = [0]

        def feature_fn(b):
            lo, pos[0] = pos[0], pos[0] + b
            return (*fused(z[lo:lo + b].to(device), feats=feats[lo:lo + b].to(device)), None)

        before = sagan_attention_fwd.launches
        out[device] = evaluate_generator(None, evaluator, mu, sigma, num_images=20, batch=8,
                                         num_splits=2, feature_fn=feature_fn)
        launched = sagan_attention_fwd.launches - before
    assert launched == 3
    for k in ("FID", "IS_mean"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= 1e-3 * abs(out["cpu"][k]), (k, out)


# --- data preparation and LPIPS --------------------------------------------------------

def _unit_bank(n, dim, clusters, seed):
    gen = torch.Generator().manual_seed(seed)
    centres = torch.randn((clusters, dim), generator=gen)
    x = centres[torch.randint(0, clusters, (n,), generator=gen)] + 0.5 * torch.randn(
        (n, dim), generator=gen)
    return torch.nn.functional.normalize(x, dim=1).numpy()


def _near_tie(d_sorted, i, tol=1e-4):
    """Whether entry ``i`` of an ascending row lies within ``tol`` of a
    neighbour."""
    lo = i > 0 and d_sorted[i] - d_sorted[i - 1] <= tol
    hi = i + 1 < len(d_sorted) and d_sorted[i + 1] - d_sorted[i] <= tol
    return lo or hi


def test_feature_bank_on_the_card_with_tf32_on():
    """``knn``, ``kmeans`` and ``closest_real_to_centroids`` on the card with
    the caller's TF32 on: the products run in full f32 all the same (the
    setting is back afterwards).  k-NN: each query's distances to its
    neighbours within 1e-4 of the float64 sorted ones, the indices equal
    away from near-ties, the radii; k-means: each row's assignment its
    float64 argmin over the final centroids (away from near-ties), each
    centroid the mean of its rows within 1e-5, and the chosen real rows the
    float64 nearest."""
    import numpy as np

    from ic_gan_tpu_torch.data.feature_bank import closest_real_to_centroids, kmeans, knn

    bank = _unit_bank(6000, 256, 40, 0)
    b64 = bank.astype(np.float64)
    cuda = torch.backends.cuda.matmul
    prev = cuda.fp32_precision
    cuda.fp32_precision = "tf32"
    try:
        idx, radii = knn(bank, k=11, device="cuda")
        centroids, assign = kmeans(bank, num_clusters=16, num_iters=20, seed=1, device="cuda")
        centres = closest_real_to_centroids(bank, centroids, device="cuda")
        assert cuda.fp32_precision == "tf32"
    finally:
        cuda.fp32_precision = prev
    for q in range(0, 6000, 47):
        d = ((b64 - b64[q]) ** 2).sum(1)
        order = np.sort(d)[:12]              # one more, for a tie at the 11th
        assert np.abs(d[idx[q]] - order[:11]).max() <= 1e-4
        want = np.argsort(d, kind="stable")[:11]
        for i in range(11):
            assert idx[q, i] == want[i] or _near_tie(order, i)
        assert abs(radii[q] - np.sqrt(order[10])) <= 1e-4
    c64 = centroids.astype(np.float64)
    dc = ((b64[:, None, :] - c64[None]) ** 2).sum(-1)
    best = dc.argmin(1)
    top2 = np.sort(dc, axis=1)[:, :2]
    ok = (assign == best) | (top2[:, 1] - top2[:, 0] <= 1e-4)
    assert ok.all()
    for k in range(16):
        members = b64[assign == k]
        if len(members):
            assert np.abs(members.mean(0) - c64[k]).max() <= 1e-5
    near = ((c64[:, None, :] - b64[None]) ** 2).sum(-1)
    assert all(centres[k] == near[k].argmin() or np.sort(near[k])[1] - near[k].min() <= 1e-4
               for k in range(16))


def test_extract_features_card_matches_cpu():
    """``iter_features`` (ResNet-50 from a seed, 224² bicubic, the flip bank)
    on the card within 1e-4 of the largest entry of the CPU's, f32."""
    import numpy as np

    from ic_gan_tpu_torch.cli.prepare_data import iter_features
    from ic_gan_tpu_torch.models.resnet import ResNet50

    imgs = np.random.RandomState(2).randint(0, 256, (6, 3, 64, 64), np.uint8)
    net = ResNet50(device="cpu", generator=torch.Generator().manual_seed(3))
    out = {}
    for device in ("cpu", "cuda"):
        rows = list(iter_features(imgs, copy.deepcopy(net).to(device), batch=4))
        out[device] = [np.concatenate([r[j] for r in rows]) for j in (2, 3)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.shape == want.shape == (6, 2048)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_lpips_card_matches_cpu_with_tf32_on():
    """``LPIPSEvaluator`` (VGG16 from a seed) on 8 pairs at 64²: the card's
    distances within 1e-4 relative of the CPU's f32 ones and equal to the
    squared feature differences, with the caller's TF32 on for
    convolutions (the evaluator runs in full f32; the setting is back
    afterwards)."""
    from ic_gan_tpu_torch.models.vgg import LPIPSEvaluator

    gen = torch.Generator().manual_seed(4)
    a = torch.tanh(torch.randn((8, 3, 64, 64), generator=gen))
    b = (a + 0.2 * torch.randn((8, 3, 64, 64), generator=gen)).clamp(-1, 1)
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        card = LPIPSEvaluator(device="cuda")
        got = card.distance(a.cuda(), b.cuda()).cpu()
        feats = card.features(torch.cat([a, b]).cuda()).cpu()
        assert conv.fp32_precision == "tf32"
    finally:
        conv.fp32_precision = prev
    want = LPIPSEvaluator(device="cpu").distance(a, b)
    assert ((got - want).abs() <= 1e-4 * want.abs()).all(), (got, want)
    via_feats = (feats[:8] - feats[8:]).square().sum(1)
    assert ((via_feats - want).abs() <= 1e-4 * want.abs()).all()


# --- int8 serving and the exported sampler ----------------------------------------

@pytest.mark.parametrize("n,c,h,w,o,k,pad", [
    (3, 6, 5, 7, 5, 3, 1),            # depth 54 and width 5 padded to multiples of 8
    (1, 5, 3, 3, 3, 3, 1),            # 9 rows: under _int_mm's 17, padded
    (2, 16, 8, 8, 24, 2, (1, 0, 0, 1)),   # an up2x phase kernel, asymmetric padding
    (5, 32, 12, 12, 64, 1, 0),        # 1x1
    (9, 24, 16, 16, 32, 3, 1),        # several chunks of the batch
])
def test_int8_conv_route_matches_plain_on_the_card(monkeypatch, n, c, h, w, o, k, pad):
    """The card's route (im2col and ``torch._int_mm``) gives the plain
    version's int32 sums bit for bit, padded rows, depth and width
    included; a small ``CHUNK_BYTES`` splits the batch into chunks."""
    from ic_gan_tpu_torch.ops import int8_conv

    monkeypatch.setattr(int8_conv, "CHUNK_BYTES", 20000)
    gen = torch.Generator(device="cuda").manual_seed(n)
    xq = torch.randint(-127, 128, (n, c, h, w), generator=gen, device="cuda", dtype=torch.int8)
    qk = torch.randint(-127, 128, (o, c, k, k), generator=gen, device="cuda", dtype=torch.int8)
    got = int8_conv.conv2d_int8(xq, qk, pad)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, int8_conv.conv2d_int8_ref(xq, qk, pad))
    assert torch.equal(got.cpu(), int8_conv.conv2d_int8(xq.cpu(), qk.cpu(), pad))


def test_int8_generator_on_the_card_matches_cpu():
    """One int8 G (calibrated once, its buffers copied to both devices),
    f32 compute: the card's images within 1e-3 mean relative of the CPU's,
    the bar of the CPU tests against JAX (the int32 sums are exact on both,
    but the float parts round differently, and a value that lands on the
    other side of a rounding edge moves its int8 code by one: a pixel may
    move by 2e-2), and B1 launched once."""
    from ic_gan_tpu_torch.io.quant import quantize_variables

    cfg = BigGANConfig(resolution=32, G_ch=16, G_attn="16", dim_z=40, shared_dim_feat=32,
                       instance_sz=64)
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    z = torch.randn((4, cfg.effective_dim_z), generator=gen)
    feats = torch.randn((4, cfg.instance_sz), generator=gen)
    quantize_variables(g, z, None, feats, skip_attention=False)
    card = copy.deepcopy(g).cuda()
    before = sagan_attention_fwd.launches
    with torch.no_grad():
        got = card(z.cuda(), None, feats.cuda()).cpu()
        want = g(z, None, feats)
    assert sagan_attention_fwd.launches == before + 1
    assert ((got - want).abs().mean() / want.abs().mean()).item() <= 1e-3


def test_exported_samplers_launch_the_kernels_on_the_card():
    """A bf16 BigGAN G with attention and an int8 StyleGAN2 G exported on
    the card and loaded back: their images the live samplers', and the
    loaded programs launch B1 and B4 (as many as the live samplers)."""
    from ic_gan_tpu_torch.io.deploy import export_sampler, load_exported_sampler
    from ic_gan_tpu_torch.io.quant import quantize_stylegan2_variables

    cfg = BigGANConfig(resolution=32, G_ch=16, G_attn="16", dim_z=40, shared_dim_feat=32,
                       instance_sz=64, dtype=torch.bfloat16)
    g = Generator(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    cast_params(g, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn((4, cfg.effective_dim_z), generator=gen, device="cuda")
    feats = torch.randn((4, cfg.instance_sz), generator=gen, device="cuda")
    live = make_sampler(g, batch_size=4)
    loaded = load_exported_sampler(export_sampler(g, 4))
    before = sagan_attention_fwd.launches
    got = loaded(z, feats=feats, device_output=True)
    torch.cuda.synchronize()
    assert sagan_attention_fwd.launches == before + 1
    assert torch.equal(got, live(z, None, feats, device_output=True))

    sg2 = SG2Generator(StyleGAN2Config(img_resolution=32, z_dim=16, c_dim=0, h_dim=24, w_dim=16,
                                       channel_base=1024, channel_max=64, num_mapping_layers=2),
                       generator=torch.Generator(device="cuda").manual_seed(2))
    z2 = torch.randn((2, 16), generator=gen, device="cuda")
    h2 = torch.randn((2, 24), generator=gen, device="cuda")
    quantize_stylegan2_variables(sg2, z2, None, h2, noise_mode="const")
    live = make_sampler(sg2, batch_size=2, noise_mode="const")
    loaded = load_exported_sampler(export_sampler(sg2, 2, noise_mode="const"))
    counts = []
    for fn in (live, loaded):
        ba.reset_launches()
        out = fn(z2, None, h2, device_output=True)
        torch.cuda.synchronize()
        counts.append(ba.bias_act_fwd.launches)
        if fn is live:
            want = out
    assert counts[0] == counts[1] > 0
    assert (out - want).abs().max().item() <= 1e-5
