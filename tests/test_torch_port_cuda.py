"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step

pytestmark = pytest.mark.cuda


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
