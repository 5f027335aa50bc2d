"""int8 serving for BigGAN and BigGAN-deep (``io/quant.py``, ``SNConv``'s and
``SelfAttention``'s int8 branches, ``ops/int8_conv.py``,
``ops/resample.py:conv3x3_nearest_up_q``) against the JAX package's
(``ic_gan_tpu/io/quant.py``), on the CPU.

The toy models of ``tests/test_quant.py``: the IC-GAN G at res 32, ch 8,
attention at 16² (``_tiny_gen``) and a res-64 deep G.  The port's G is drawn
from a seed, moved off its init and folded; the JAX variables come from its
state dict.  One module fixture quantizes it in JAX (every conv, the
attention's included) and runs JAX's int8 G once on those records, so
each whole-model test shares one calibration and one compiled forward.
Bars: int8 codes, int32 sums and weight scales exactly JAX's; layer outputs
within 1e-6 relative in f32; activation scales within 1e-5 relative (the
calibration forward's f32 rounding); whole-G images within 1e-3 mean
relative with JAX's records carried across, and 99.9 % of the codes at a
hooked layer's input equal to JAX's, the rest one apart (an f32 rounding
upstream can move a value across a rounding edge); int8 against float
0 < rel < 0.1, the JAX tests' bar.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.io import quant as jquant
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu.models import layers as jlayers
from ic_gan_tpu.ops import resample as jresample
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.io import quant as tquant
from ic_gan_tpu_torch.io.deploy import fold_spectral_norm
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import biggan_deep as tdeep
from ic_gan_tpu_torch.models import layers as tlayers
from ic_gan_tpu_torch.ops import int8_conv
from ic_gan_tpu_torch.ops.resample import conv3x3_nearest_up_q
from test_torch_port_biggan_deep import _perturb, jax_variables
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401

TINY = dict(resolution=32, G_ch=8, G_attn="16", dim_z=12, shared_dim_feat=16, instance_sz=24)
BATCH = 4


def _quant_x(x, sx):
    return np.clip(np.round(np.asarray(x, np.float32) / sx), -127, 127).astype(np.int8)


def tiny_gen(seed=0):
    """The port's ``_tiny_gen``: folded, perturbed off its init, float32."""
    cfg = tbiggan.BigGANConfig(**TINY)
    g = tbiggan.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return cfg, fold_spectral_norm(_perturb(g, seed))


def inputs(cfg, seed=3, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, cfg.effective_dim_z).astype(np.float32),
            rng.randn(n, cfg.instance_sz).astype(np.float32))


def _jax_paths(cfg):
    """JAX conv path → the port's module name, through the key map."""
    return {path[1:-1]: key[:-len(".weight")]
            for path, (key, _) in convert.generator_key_map(cfg).items()
            if path[0] == "params" and path[-1] == "kernel" and key.endswith(".weight")}


def _quant_leaves(tree, path=()):
    if "qkernel" in tree:
        yield path, tree
        return
    for k, v in tree.items():
        yield from _quant_leaves(v, path + (k,))


@pytest.fixture(scope="module")
def jax_int8():
    """JAX's records for the folded tiny G (every conv quantized), and JAX's
    int8 G run on those records less the attention's (its default) with
    block 0's output captured."""
    cfg, g = tiny_gen()
    key_map = {p: v for p, v in convert.generator_key_map(cfg).items() if p[0] != "sn"}
    variables = jax_variables(g.state_dict(), key_map)
    jg = jbiggan.Generator(jbiggan.BigGANConfig(**TINY))
    z, f = inputs(cfg)
    qv = jquant.quantize_variables(jg, variables, jnp.asarray(z), None, jnp.asarray(f),
                                   skip_attention=False, train=False)
    records = jax.device_get(qv["quant"])
    default = {k: v for k, v in records.items() if not k.startswith("attn")}
    run = cheap_jit(lambda v, z, f: jg.apply(v, z, None, f, train=False,
                                             capture_intermediates=True,
                                             mutable=["intermediates"]))
    out, inter = run(dict(variables, quant=default), z, f)
    return dict(cfg=cfg, g=g, records=records, default=default, z=z, f=f,
                out=np.asarray(out), block0=np.asarray(inter["intermediates"]["block_0"]
                                                      ["__call__"][0]))


# --- the pieces --------------------------------------------------------------------

def test_quantize_kernel_codes_and_scales_are_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)      # HWIO
    w[1, 1, 2, 5] = 127.5 * np.abs(w[..., 5]).max() / 127.0   # a tie-prone tap
    jq, js = jquant._quantize_kernel(jnp.asarray(w))
    q, s = tquant._quantize_kernel(torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (16,)
    np.testing.assert_array_equal(q.numpy(), np.transpose(np.asarray(jq), (3, 2, 0, 1)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q.abs().amax(dim=(1, 2, 3)) == 127).all()


def test_snconv_and_up_q_int32_sums_match_jax():
    """The same int8 input through an int8 SNConv (3×3 and 1×1) and through
    ``conv3x3_nearest_up_q``: the int32 sums of the plain version and of the
    card's im2col route (run here on the CPU) equal XLA's exactly, and the
    dequantized outputs JAX's within 1e-6 relative."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)                    # NHWC
    sx = float(np.abs(x).max()) / 127.0
    xq = _quant_x(x, sx)
    txq = torch.from_numpy(np.transpose(xq, (0, 3, 1, 2)).copy())
    for k in (3, 1):
        w = (0.2 * rng.randn(k, k, 6, 10)).astype(np.float32)
        qk, ws = jquant._quantize_kernel(jnp.asarray(w))
        tqk = torch.from_numpy(np.transpose(np.asarray(qk), (3, 2, 0, 1)).copy())
        sums = jax.lax.conv_general_dilated(
            jnp.asarray(xq), qk, (1, 1), ((k // 2, k // 2),) * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        want = np.transpose(np.asarray(sums), (0, 3, 1, 2))
        for conv in (int8_conv.conv2d_int8, int8_conv.im2col_int_mm):
            got = conv(txq, tqk, k // 2)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        b = rng.randn(10).astype(np.float32)
        jout = jlayers.SNConv(10, kernel_size=(k, k)).apply(
            {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
             "quant": {"act_scale": jnp.float32(sx), "qkernel": qk, "wscale": ws}},
            jnp.asarray(x))
        layer = tlayers.SNConv(6, 10, k, device="cpu")
        layer.fold_()
        tquant._set_quant(layer, act_scale=torch.tensor(sx, dtype=torch.float32),
                          qkernel=tqk, wscale=torch.from_numpy(np.array(ws)))
        with torch.no_grad():
            layer.bias.copy_(torch.from_numpy(b))
            got = layer(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                                   rtol=1e-6, atol=1e-6 * float(np.abs(jout).max()))
    w3 = (0.1 * rng.randn(3, 3, 6, 5)).astype(np.float32)
    phases = [jquant._quantize_kernel(k) for k in jresample.polyphase_up_kernels(jnp.asarray(w3))]
    qk4, ws4 = jnp.stack([q for q, _ in phases]), jnp.stack([s for _, s in phases])
    jout = np.asarray(jresample.conv3x3_nearest_up_q(jnp.asarray(xq), qk4, ws4 * sx, jnp.float32))
    tqk4 = torch.from_numpy(np.transpose(np.asarray(qk4), (0, 4, 3, 1, 2)).copy())
    got = conv3x3_nearest_up_q(txq, tqk4, torch.from_numpy(np.array(ws4 * sx)), torch.float32)
    assert got.shape == (2, 5, 16, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), jout, rtol=1e-6,
                               atol=1e-6 * float(np.abs(jout).max()))
    # The phase kernels the port quantizes are JAX's.
    ported = tquant._quantize_kernel(
        torch.from_numpy(np.transpose(np.asarray(jresample.polyphase_up_kernels(
            jnp.asarray(w3))[1]), (3, 2, 0, 1)).copy()))[0]
    np.testing.assert_array_equal(ported.numpy(), tqk4[1].numpy())


# --- calibration ---------------------------------------------------------------------

def test_calibration_records_jax_convs_and_scales(jax_int8):
    """Every conv of G records, attention's too with the fusion off; the
    default quantizes all but the attention's, the polyphase conv1 as four
    phase kernels; each activation scale within 1e-5 of JAX's."""
    cfg, records = jax_int8["cfg"], jax_int8["records"]
    names = _jax_paths(cfg)
    g = copy.deepcopy(jax_int8["g"])
    z, f = (torch.from_numpy(a) for a in (jax_int8["z"], jax_int8["f"]))
    scales = tquant.calibrate_conv_scales(g, z, None, f)
    assert set(scales) == {names[p] for p, _ in _quant_leaves(records)}
    assert {"theta", "phi", "g", "o", "conv1", "conv2", "conv_sc"} <= \
        {n.rsplit(".", 1)[-1] for n in scales}
    for name, (absmax, up2x, down2x) in scales.items():
        assert absmax > 0 and not down2x and up2x == name.endswith("conv1"), name
    assert tlayers._ATTN_FUSION[0]
    for skip in (True, False):
        gq = tquant.quantize_variables(copy.deepcopy(g), z, None, f, skip_attention=skip)
        state = gq.state_dict()
        quantized = {k[:-len(".qkernel")] for k in state if k.endswith(".qkernel")}
        want = {names[p] for p, _ in _quant_leaves(records)
                if not (skip and p[0].startswith("attn"))}
        assert quantized == want
        for path, rec in _quant_leaves(records):
            if names[path] not in quantized:
                continue
            np.testing.assert_allclose(state[names[path] + ".act_scale"].numpy(),
                                       rec["act_scale"], rtol=1e-5)
            # An ulp apart at most: JAX builds its records in one jitted
            # function, whose compiled divide need not round as the eager
            # one (``_quantize_kernel`` above is bit for bit), and a phase
            # kernel's taps sum up to four taps in XLA's order.
            np.testing.assert_allclose(state[names[path] + ".wscale"].numpy(), rec["wscale"],
                                       rtol=2.5e-7, atol=0)
    assert state["blocks.0.0.conv1.qkernel"].shape == (4, 32, 32, 2, 2)


def test_down2x_convs_are_left_float():
    """A discriminator's ``down2x`` convs record their input but stay float."""
    cfg = tbiggan.BigGANConfig(resolution=32, D_ch=4, D_attn="0", instance_sz=8)
    d = tbiggan.Discriminator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32))
    feats = torch.zeros(2, 8)
    scales = tquant.calibrate_conv_scales(d, x, None, feats)
    down = {n for n, (_, _, dn) in scales.items() if dn}
    assert down and len(down) < len(scales)
    state = tquant.quantize_variables(d, x, None, feats).state_dict()
    quantized = {k[:-len(".qkernel")] for k in state if k.endswith(".qkernel")}
    assert quantized == set(scales) - down


def test_deep_calibration_covers_bottleneck_convs_and_serves_int8():
    """The deep G (res 64, so the channel-drop shortcut runs): every
    bottleneck conv records, only an upsampling block's conv2 is polyphase,
    its 1×1 convs quantize to int8, and its int8 images stay near float."""
    cfg = tdeep.BigGANDeepConfig(resolution=64, n_classes=10, G_ch=4, dim_z=12, G_attn="0",
                                 G_depth=2, shared_dim=16, shared_dim_feat=16, instance_sz=24,
                                 class_cond=False, instance_cond=True)
    g = tdeep.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(7)
    z = torch.from_numpy(rng.randn(BATCH, cfg.effective_dim_z).astype(np.float32))
    f = torch.from_numpy(rng.randn(BATCH, cfg.instance_sz).astype(np.float32))
    fold_spectral_norm(g)
    scales = tquant.calibrate_conv_scales(g, z, None, f)
    assert {"conv1", "conv2", "conv3", "conv4"} <= {n.rsplit(".", 1)[-1] for n in scales}
    ups = [n for n, (_, up2x, _) in scales.items() if up2x]
    assert ups and all(n.endswith(".conv2") for n in ups)
    with torch.no_grad():
        ref = g(z, None, f)
        tquant.quantize_variables(g, z, None, f)
        out = g(z, None, f)
    one_by_one = [v for k, v in g.state_dict().items()
                  if k.endswith(".qkernel") and v.dim() == 4 and v.shape[2:] == (1, 1)]
    assert one_by_one and all(v.dtype == torch.int8 for v in one_by_one)
    rel = float((out - ref).abs().mean() / ref.abs().mean())
    assert torch.isfinite(out).all() and 0 < rel < 0.1, rel


# --- whole G ----------------------------------------------------------------------------

def test_int8_generator_matches_jax_on_its_records(jax_int8):
    """JAX's records carried into the port's buffers: the int8 images within
    1e-3 mean relative of JAX's, and the int8 codes at block 1's shortcut
    conv (block 0's output) JAX's, but for at most 0.1 % one apart."""
    cfg = jax_int8["cfg"]
    g = copy.deepcopy(jax_int8["g"])
    tquant.load_quant_state_dict(g, convert.generator_quant_from_jax(jax_int8["default"], cfg))
    assert g.blocks[0][0].conv1.quantized and not g.blocks[1][1].theta.quantized
    seen = {}

    def record(m, args):
        seen["xq"] = tlayers.quantize_activation(args[0], m.act_scale)

    hook = g.blocks[1][0].conv_sc.register_forward_pre_hook(record)
    with torch.no_grad():
        out = g(torch.from_numpy(jax_int8["z"]), None, torch.from_numpy(jax_int8["f"]))
    hook.remove()
    want = jax_int8["out"]
    got = out.permute(0, 2, 3, 1).numpy()
    rel = np.abs(got - want).mean() / np.abs(want).mean()
    assert rel <= 1e-3, rel
    sx = float(jax_int8["default"]["block_1"]["conv_sc"]["act_scale"])
    jcodes = _quant_x(jax_int8["block0"], sx).astype(np.int32)
    codes = seen["xq"].permute(0, 2, 3, 1).numpy().astype(np.int32)
    diff = np.abs(codes - jcodes)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, ((diff == 0).mean(), diff.max())


def test_int8_against_float_and_drop_quant(jax_int8):
    """int8 images near the float ones (0 < rel < 0.1); removing the int8
    buffers gives the float path back bit for bit."""
    g = copy.deepcopy(jax_int8["g"])
    z, f = torch.from_numpy(jax_int8["z"]), torch.from_numpy(jax_int8["f"])
    with torch.no_grad():
        ref = g(z, None, f)
        tquant.quantize_variables(g, z, None, f)
        out = g(z, None, f)
        rel = float((out - ref).abs().mean() / ref.abs().mean())
        assert torch.isfinite(out).all() and 0 < rel < 0.1, rel
        tquant.drop_quant(g)
        assert not any(k.endswith(tquant.QUANT_BUFFERS) for k in g.state_dict())
        assert torch.equal(g(z, None, f), ref)


def test_fused_int8_attention_equals_per_conv(jax_int8):
    """``skip_attention=False``: θ, φ and g calibrate on one input, so one
    activation scale; the fused θ/φ/g int8 conv equals the three per-conv
    ones, and the int8 G with its attention quantized stays near float."""
    g = copy.deepcopy(jax_int8["g"])
    z, f = torch.from_numpy(jax_int8["z"]), torch.from_numpy(jax_int8["f"])
    with torch.no_grad():
        ref = g(z, None, f)
        tquant.quantize_variables(g, z, None, f, skip_attention=False)
        attn = g.blocks[1][1]
        assert attn.theta.act_scale == attn.phi.act_scale == attn.g.act_scale
        assert attn.o.quantized
        x = torch.from_numpy(np.random.RandomState(5).randn(2, 32, 16, 16).astype(np.float32))
        fused = attn(x)
        tlayers._ATTN_FUSION[0] = False
        try:
            per_conv = attn(x)
        finally:
            tlayers._ATTN_FUSION[0] = True
        torch.testing.assert_close(fused, per_conv, rtol=1e-5, atol=1e-6)
        out = g(z, None, f)
    rel = float((out - ref).abs().mean() / ref.abs().mean())
    assert torch.isfinite(out).all() and 0 < rel < 0.1, rel
