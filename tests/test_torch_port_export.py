"""The exported sampler (``io/deploy.py:export_sampler``,
``load_exported_sampler``): the six cases of ``tests/test_export.py`` on the
port, on the CPU.  No JAX is needed: the contract is the port's own.

A saved ``torch.export`` program holds the folded (cast or int8) weights
and the fixed-batch forward; loaded from its bytes it gives the live
sampler's images within 1e-5, with absent conditioning as zero-width
placeholders.  The attention and bias-activation kernels stay in the
program as the ops ``ic_gan_tpu::sagan_attention_fwd`` and
``ic_gan_tpu::bias_act_fwd`` (on the CPU their plain versions run).  The
BigGAN toys carry an attention block at 16², so that the first op shows.
"""

import numpy as np
import pytest
import torch

from ic_gan_tpu_torch.io import quant as tquant
from ic_gan_tpu_torch.io.deploy import export_sampler, load_exported_sampler, make_sampler
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import biggan_deep as tdeep
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.models.layers import SelfAttention

ATOL = 1e-5
SG2 = dict(img_resolution=32, z_dim=16, c_dim=0, h_dim=24, w_dim=16, channel_base=1024,
           channel_max=64, num_mapping_layers=2, num_fp16_res=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(class_cond=False, seed=0):
    cfg = tbiggan.BigGANConfig(resolution=32, n_classes=10, G_ch=8, dim_z=20, G_attn="16",
                               shared_dim=16, shared_dim_feat=24, instance_sz=32,
                               class_cond=class_cond)
    g = tbiggan.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    for m in g.modules():
        if isinstance(m, SelfAttention):
            m.gamma.data.fill_(0.5)
    return g, cfg


def _sg2(seed=0):
    g = tsg2.Generator(tsg2.StyleGAN2Config(**SG2), device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    return g


def _ops(sampler):
    return {str(n.target) for n in sampler.program.graph.nodes if "ic_gan_tpu" in str(n.target)}


@pytest.fixture(scope="module")
def biggan_export():
    g, cfg = _toy()
    data = export_sampler(g, 4, device="cpu")
    return dict(g=g, cfg=cfg, data=data)


def test_export_roundtrip_matches_live_sampler(biggan_export, tmp_path):
    g, cfg, data = biggan_export["g"], biggan_export["cfg"], biggan_export["data"]
    assert isinstance(data, bytes) and len(data) > 1000
    path = tmp_path / "sampler.pt2"
    path.write_bytes(data)
    sampler = load_exported_sampler(path.read_bytes())
    assert _ops(sampler) == {"ic_gan_tpu.sagan_attention_fwd.default"}
    assert [tuple(s.shape) for s in sampler.specs] == [(4, cfg.effective_dim_z), (4, 0),
                                                        (4, cfg.instance_sz)]
    rng = np.random.RandomState(0)
    z = rng.randn(4, cfg.effective_dim_z).astype(np.float32)
    feats = rng.randn(4, cfg.instance_sz).astype(np.float32)
    got = sampler(z, feats=feats)
    want = make_sampler(g, batch_size=4, device="cpu")(z, None, feats)
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_export_class_conditional():
    g, cfg = _toy(class_cond=True)
    sampler = load_exported_sampler(export_sampler(g, 2, device="cpu"))
    rng = np.random.RandomState(1)
    z = rng.randn(2, cfg.effective_dim_z).astype(np.float32)
    feats = rng.randn(2, cfg.instance_sz).astype(np.float32)
    label = np.asarray([1, 7])
    got = sampler(z, label, feats)
    want = make_sampler(g, batch_size=2, device="cpu")(z, label, feats)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # The labels are live in the program.
    assert np.abs(got - sampler(z, np.asarray([3, 4]), feats)).max() > 1e-4


@pytest.fixture(scope="module")
def sg2_export():
    g = _sg2()
    return dict(g=g, sampler=load_exported_sampler(
        export_sampler(g, 2, device="cpu", noise_mode="const")))


def test_export_stylegan2_backbone(sg2_export):
    """Constant noise baked in, the instance features live; random noise
    cannot be exported."""
    g, sampler = sg2_export["g"], sg2_export["sampler"]
    with pytest.raises(ValueError, match="noise_mode"):
        export_sampler(_sg2(), 2, device="cpu")
    assert _ops(sampler) == {"ic_gan_tpu.bias_act_fwd.default"}
    rng = np.random.RandomState(2)
    z = rng.randn(2, SG2["z_dim"]).astype(np.float32)
    feats = rng.randn(2, SG2["h_dim"]).astype(np.float32)
    got = sampler(z, feats=feats)
    want = make_sampler(g, batch_size=2, device="cpu", noise_mode="const")(z, None, feats)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got - sampler(z, feats=feats + 1.0)).max() > 1e-4


def test_export_biggan_deep_backbone():
    """Bottleneck blocks and the channel-drop shortcut (res 64), classes and
    instances."""
    cfg = tdeep.BigGANDeepConfig(resolution=64, n_classes=10, G_ch=4, dim_z=16, G_attn="0",
                                 G_depth=2, shared_dim=16, shared_dim_feat=24, instance_sz=32,
                                 class_cond=True, instance_cond=True)
    g = tdeep.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sampler = load_exported_sampler(export_sampler(g, 2, device="cpu"))
    rng = np.random.RandomState(3)
    z = rng.randn(2, cfg.effective_dim_z).astype(np.float32)
    feats = rng.randn(2, cfg.instance_sz).astype(np.float32)
    label = np.asarray([2, 8])
    got = sampler(z, label, feats)
    want = make_sampler(g, batch_size=2, device="cpu")(z, label, feats)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_export_quantized_biggan(biggan_export):
    """An int8 G (its int8 buffers) rides the program; the loaded sampler
    gives the live int8 images, not the float ones."""
    g, cfg = _toy()
    rng = np.random.RandomState(4)
    zc = torch.from_numpy(rng.randn(4, cfg.effective_dim_z).astype(np.float32))
    fc = torch.from_numpy(rng.randn(4, cfg.instance_sz).astype(np.float32))
    tquant.quantize_variables(g, zc, None, fc)
    sampler = load_exported_sampler(export_sampler(g, 4, device="cpu"))
    assert _ops(sampler) == {"ic_gan_tpu.sagan_attention_fwd.default"}
    z = rng.randn(4, cfg.effective_dim_z).astype(np.float32)
    feats = rng.randn(4, cfg.instance_sz).astype(np.float32)
    got = sampler(z, feats=feats)
    np.testing.assert_allclose(got, make_sampler(g, batch_size=4, device="cpu")(z, None, feats),
                               atol=ATOL)
    plain = load_exported_sampler(biggan_export["data"])(z, feats=feats)
    assert np.abs(got - plain).max() > 1e-4


def test_export_quantized_stylegan2(sg2_export):
    g = _sg2()
    rng = np.random.RandomState(5)
    zc = torch.from_numpy(rng.randn(2, SG2["z_dim"]).astype(np.float32))
    fc = torch.from_numpy(rng.randn(2, SG2["h_dim"]).astype(np.float32))
    plain = sg2_export["sampler"]
    tquant.quantize_stylegan2_variables(g, zc, None, fc, noise_mode="const")
    sampler = load_exported_sampler(export_sampler(g, 2, device="cpu", noise_mode="const"))
    assert _ops(sampler) == {"ic_gan_tpu.bias_act_fwd.default"}
    z = rng.randn(2, SG2["z_dim"]).astype(np.float32)
    feats = rng.randn(2, SG2["h_dim"]).astype(np.float32)
    got = sampler(z, feats=feats)
    want = make_sampler(g, batch_size=2, device="cpu", noise_mode="const")(z, None, feats)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got - plain(z, feats=feats)).max() > 1e-4
