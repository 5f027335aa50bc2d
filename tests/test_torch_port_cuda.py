"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; without a CUDA device every test skips (the kernels have no
CPU mode).  On a machine with a card, where the JAX package need not be
installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q
"""

import pytest
import torch

from ic_gan_tpu_torch.io.deploy import cast_params, make_sampler
from ic_gan_tpu_torch.models.biggan import BigGANConfig, Generator
from ic_gan_tpu_torch.ops.attention import sagan_attention, sagan_attention_ref

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
    before = sagan_attention.launches
    got = sagan_attention(*args)
    torch.cuda.synchronize()
    assert sagan_attention.launches == before + 1
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
    before = sagan_attention.launches
    out = sampler(z, feats=feats)
    assert sagan_attention.launches == before + 2
    assert out.shape == (7, 32, 32, 3) and (abs(out) <= 1).all()
