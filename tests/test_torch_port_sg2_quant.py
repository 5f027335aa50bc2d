"""int8 serving for StyleGAN2 (``io/quant.py:quantize_stylegan2_variables``,
``models/stylegan2.py``'s int8 modulated conv) and ``load_model_inference``
with ``quantize_serving`` for both backbones, against the JAX package's
(``ic_gan_tpu/io/quant.py``, ``models/stylegan2.py:96-203``), on the CPU.

The toy G of ``tests/test_quant.py`` (``_tiny_sg2``: res 32,
``channel_base`` 4096), drawn from a seed in the port with its biases and
noise strengths moved off zero; the JAX variables come from its state dict.
One module fixture quantizes it in JAX and runs JAX's int8 G once on those
records.  Bars as ``test_torch_port_quant.py``'s: layer outputs within 1e-5
in f32, activation scales within 1e-5 relative and the weight scales,
which fold them in, within 2e-5; int8 kernels JAX's but for a rare
one-apart code where a tap sits that close to a rounding edge; whole-G
images within 1e-3 mean relative on JAX's records, 99.9 % of the codes at
a hooked layer JAX's; int8 against float below JAX's bars (0.1,
per-channel 0.03, the CLI 0.15).
"""

import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.io import quant as jquant
from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu.ops import conv_resample as jconv_resample
from ic_gan_tpu.ops import resample as jresample
from ic_gan_tpu_torch.cli import inference as tinf
from ic_gan_tpu_torch.cli.config import split_config
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.io import quant as tquant
from ic_gan_tpu_torch.io.checkpoint import save_checkpoint
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.ops.conv_resample import _compose_kernel
from ic_gan_tpu_torch.ops.int8_conv import conv2d_int8_ref
from ic_gan_tpu_torch.train.state import GANTrainState
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401
from test_torch_port_sg2_import import tf_pickle  # noqa: F401

TINY_SG2 = dict(img_resolution=32, w_dim=64, z_dim=48, h_dim=24, c_dim=0, channel_base=4096,
                channel_max=64, num_mapping_layers=2)
N = 4


def tiny_sg2(seed=0, **kw):
    """The port's ``_tiny_sg2`` (JAX's defaults, bf16 from 8² on, unless
    ``kw`` says otherwise), biases and noise strengths off zero."""
    g = tsg2.Generator(tsg2.StyleGAN2Config(**{**TINY_SG2, **kw}), device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith((".bias", "noise_strength")) and "mapping" not in name:
                p.copy_(torch.tensor(0.1 * rng.randn(*p.shape), dtype=torch.float32))
    return g


def _zh(seed=7, n=N):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, TINY_SG2["z_dim"]).astype(np.float32)),
            torch.from_numpy(rng.randn(n, TINY_SG2["h_dim"]).astype(np.float32)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _codes(xm, sx):
    return np.clip(np.round(np.asarray(xm, np.float32) / sx), -127, 127).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.fixture(scope="module")
def jax_int8():
    """JAX's records for the f32 tiny G (static per-channel, its default),
    and JAX's int8 G on them with ``synthesis.b16``'s conv0 output and
    conv1 styles captured."""
    g = tiny_sg2(num_fp16_res=0)
    variables = convert.stylegan2_variables_from_state_dict(g.state_dict())
    jg = jsg2.Generator(jsg2.StyleGAN2Config(**TINY_SG2, num_fp16_res=0))
    z, h = _zh()
    qv = jquant.quantize_stylegan2_variables(jg, variables, jnp.asarray(z.numpy()), None,
                                             jnp.asarray(h.numpy()), noise_mode="const")
    records = jax.device_get(qv["quant"])
    run = cheap_jit(lambda v, z, h: jg.apply(v, z, None, h, noise_mode="const",
                                             capture_intermediates=True,
                                             mutable=["intermediates"]))
    out, inter = run(dict(variables, quant=records), z.numpy(), h.numpy())
    b16 = inter["intermediates"]["synthesis"]["b16"]
    return dict(g=g, z=z, h=h, records=records, out=np.asarray(out),
                x=np.asarray(b16["conv0"]["__call__"][0]),
                styles=np.asarray(b16["conv1"]["affine"]["__call__"][0]))


# --- the modulated conv --------------------------------------------------------------

def test_modulated_conv_int8_matches_jax():
    """One input through the int8 modulated conv of both packages: up 1 with
    a per-tensor scale, and up 2 with per-channel scales on the composite
    polyphase kernel (the flipped weight composed with the FIR, built and
    quantized by both packages alike); the demodulation from the raw
    weight, noise added."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)                  # NHWC
    styles = np.exp(0.5 * rng.randn(2, 6)).astype(np.float32)
    xm = x * styles[:, None, None, :]
    tx = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
    for up in (1, 2):
        w = (0.2 * rng.randn(3, 3, 6, 10)).astype(np.float32)     # HWIO
        noise = (0.1 * rng.randn(1, 8 * up, 8 * up, 1)).astype(np.float32)
        tw = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy())
        if up == 1:
            sx = np.float32(np.abs(xm).max() / 127.0)
            qk, ws = jquant._quantize_kernel(jnp.asarray(w))
            f = None
        else:
            sx = (np.abs(xm).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
            wa = w * sx[None, None, :, None]
            f = jresample.setup_filter(jnp.asarray([1.0, 3.0, 3.0, 1.0]))
            k = jconv_resample._compose_kernel(jnp.flip(jnp.asarray(wa), (0, 1)),
                                               jnp.outer(f, f) * 4.0)
            qs = [jquant._quantize_kernel(k[(3 - a) % 2::2, (3 - b) % 2::2])
                  for a in (0, 1) for b in (0, 1)]
            qk = jnp.concatenate([q for q, _ in qs], axis=-1)
            ws = jnp.stack([s for _, s in qs])
            tk = _compose_kernel(torch.from_numpy(np.transpose(wa, (3, 2, 0, 1)).copy())
                                 .flip(2, 3), torch.outer(*(torch.tensor(
                                     [1.0, 3.0, 3.0, 1.0]) / 8.0,) * 2) * 4.0)
            tcodes = torch.cat([
                tquant._quantize_kernel(tk[:, :, (3 - a) % 2::2, (3 - b) % 2::2])[0]
                for a in (0, 1) for b in (0, 1)])
            jcodes = np.transpose(np.asarray(qk), (3, 2, 0, 1))
            assert np.abs(tcodes.numpy().astype(int) - jcodes).max() <= 1
            assert (tcodes.numpy() == jcodes).mean() >= 0.999
        quant = {"act_scale": jnp.asarray(sx), "qkernel": qk, "wscale": ws}
        want = jsg2.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(styles),
                                     noise=jnp.asarray(noise), up=up, padding=1,
                                     resample_filter=f, flip_weight=(up == 1), quant=quant)
        tq = dict(act_scale=torch.from_numpy(np.array(sx)),
                  qkernel=convert.stylegan2_quant_from_jax({"q": {"qkernel": qk}})["q.qkernel"],
                  wscale=torch.from_numpy(np.array(ws)))
        got = tsg2.modulated_conv2d(tx, tw, torch.from_numpy(styles),
                                    noise=torch.from_numpy(np.transpose(noise, (0, 3, 1, 2))),
                                    up=up, padding=1, flip_weight=(up == 1), quant=tq)
        assert got.shape == (2, 10, 8 * up, 8 * up)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_act_dynamic_algebra_and_its_unbounded_boost():
    """``act_dynamic``: the per-sample boost 127/t applied before the int8
    conv and undone after, t the sample's largest |xm / act_scale| (the
    explicit algebra, and JAX's output).  t has no floor but 1e-30, so a
    sample far below its calibrated range is boosted without bound (here by
    10⁴ and more) to the full int8 range, as the JAX package does."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 8, 8, 6).astype(np.float32)
    w = (0.2 * rng.randn(3, 3, 6, 10)).astype(np.float32)
    styles = np.exp(rng.randn(3, 6)).astype(np.float32)
    xm = x * styles[:, None, None, :]
    qk, ws = jquant._quantize_kernel(jnp.asarray(w))
    tqk = torch.from_numpy(np.transpose(np.asarray(qk), (3, 2, 0, 1)).copy())
    for loose in (2.0, 1e4):
        sx = np.float32(np.abs(xm).max() / 127.0 * loose)
        jq = {"act_scale": jnp.asarray(sx), "qkernel": qk, "wscale": ws,
              "act_dynamic": jnp.int8(1)}
        want = np.asarray(jsg2.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(styles), padding=1, quant=jq))
        tq = dict(act_scale=torch.tensor(sx), qkernel=tqk, wscale=torch.from_numpy(np.array(ws)),
                  act_dynamic=torch.ones((), dtype=torch.int8))
        got = tsg2.modulated_conv2d(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()),
                                    torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
                                    torch.from_numpy(styles), padding=1, quant=tq)
        xs = xm / sx
        t = np.maximum(np.abs(xs).max(axis=(1, 2, 3), keepdims=True), 1e-30)
        codes = np.clip(np.round(xs * (127.0 / t)), -127, 127)
        assert np.abs(codes).max() == 127 and (127.0 / t).min() >= loose
        y = conv2d_int8_ref(torch.from_numpy(np.transpose(codes, (0, 3, 1, 2)).astype(np.int8)),
                            tqk, 1).numpy().astype(np.float32)
        w2 = np.square(w).sum(axis=(0, 1))
        d = 1.0 / np.sqrt(np.square(styles) @ w2 + 1e-8)
        ref = y * (np.asarray(ws) * sx)[:, None, None] * (t / 127.0).reshape(-1, 1, 1, 1) \
            * d[:, :, None, None]
        for other in (ref, np.transpose(want, (0, 3, 1, 2))):
            np.testing.assert_allclose(got.numpy(), other, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(other).max()))


# --- whole G ---------------------------------------------------------------------------

def test_sg2_calibration_and_int8_generator_match_jax(jax_int8):
    """The port's own records are JAX's (every synthesis conv, no ToRGB;
    activation scales per input channel), and on JAX's records carried
    across the int8 images are JAX's within 1e-3 mean relative, the codes
    at ``b16.conv1``'s input JAX's but for at most 0.1 % one apart."""
    records = jax_int8["records"]
    jrec = convert.stylegan2_quant_from_jax(records)
    g = copy.deepcopy(jax_int8["g"])
    z, h = jax_int8["z"], jax_int8["h"]
    tquant.quantize_stylegan2_variables(g, z, None, h, noise_mode="const")
    own = {k: v for k, v in g.state_dict().items() if k.endswith(tquant.QUANT_BUFFERS)}
    assert set(own) == set(jrec) and not any("torgb" in k for k in own)
    assert any(".conv0." in k for k in own) and any(".conv1." in k for k in own)
    for k, v in own.items():
        if k.endswith(".act_scale"):
            assert v.dim() == 1
            np.testing.assert_allclose(v.numpy(), jrec[k].numpy(), rtol=1e-5)
        elif k.endswith(".wscale"):
            # The weight carries the activation scales folded in.
            np.testing.assert_allclose(v.numpy(), jrec[k].numpy(), rtol=2e-5)
        else:
            diff = (v.int() - jrec[k].int()).abs()
            assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999, k
    assert own["synthesis.b16.conv0.qkernel"].shape == (4 * 64, 64, 3, 3)

    g = copy.deepcopy(jax_int8["g"])
    tquant.load_quant_state_dict(g, jrec)
    seen = {}
    layer = g.synthesis.b16.conv1

    def record(m, args):
        x, w = args[:2]
        seen["codes"] = _codes(_nhwc(x * m.affine(w)[:, :, None, None]),
                               m.act_scale.numpy())
    hook = layer.register_forward_pre_hook(record)
    with torch.no_grad():
        out = g(z, None, h, noise_mode="const")
    hook.remove()
    assert _rel(_nhwc(out), jax_int8["out"]) <= 1e-3
    jcodes = _codes(jax_int8["x"] * jax_int8["styles"][:, None, None, :],
                    records["synthesis"]["b16"]["conv1"]["act_scale"])
    diff = np.abs(seen["codes"] - jcodes)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, ((diff == 0).mean(), diff.max())
    # Without its int8 buffers the G is the float one, bit for bit.
    with torch.no_grad():
        ref = jax_int8["g"](z, None, h, noise_mode="const")
        assert 0 < _rel(_nhwc(out), _nhwc(ref)) < 0.1
        assert torch.equal(tquant.drop_quant(g)(z, None, h, noise_mode="const"), ref)


def test_per_channel_beats_per_tensor_and_dynamic_beats_static():
    """On the tiny G (bf16 from 8²): per-channel activation scales drift
    less than the per-tensor one and under 0.03; on a fresh stream the
    dynamic mode drifts less than the static one (JAX ``test_quant.py:469``
    and ``:490``)."""
    g = tiny_sg2()
    z, h = _zh()
    z2, h2 = _zh(77)
    with torch.no_grad():
        ref, ref2 = (g(a, None, b, noise_mode="const") for a, b in ((z, h), (z2, h2)))
        drift = {}
        for name, kw in (("pc", {}), ("pt", dict(per_channel_act=False)),
                         ("dyn", dict(act_dynamic=True))):
            gq = tquant.quantize_stylegan2_variables(copy.deepcopy(g), z, None, h,
                                                     noise_mode="const", **kw)
            scales = [v for k, v in gq.state_dict().items() if k.endswith(".act_scale")]
            assert scales and all(s.dim() == (0 if name == "pt" else 1) for s in scales)
            marks = [k for k in gq.state_dict() if k.endswith(".act_dynamic")]
            assert bool(marks) == (name == "dyn")
            out = gq(*((z2, None, h2) if name == "dyn" else (z, None, h)), noise_mode="const")
            assert torch.isfinite(out).all()
            drift[name] = _rel(out, ref2 if name == "dyn" else ref)
            if name == "pc":
                drift["static fresh"] = _rel(gq(z2, None, h2, noise_mode="const"), ref2)
    assert drift["pc"] < drift["pt"] and drift["pc"] < 0.03, drift
    assert drift["dyn"] < drift["static fresh"], drift


# --- load_model_inference ----------------------------------------------------------

FLAT = dict(resolution=32, n_classes=2, G_ch=4, D_ch=4, dim_z=8, G_attn="0", D_attn="0",
            shared_dim=8, shared_dim_feat=8, instance_cond=True, G_shared_feat=True,
            hier=True, experiment_name="exp", load_weights="", batch_size=4)


def _native_checkpoint(root):
    flat = dict(FLAT, weights_root=str(root))
    model_cfg, train_cfg = split_config(flat, inference=True)[:2]
    gen = torch.Generator().manual_seed(0)
    g = tbiggan.Generator(model_cfg, device="cpu", generator=gen)
    d = tbiggan.Discriminator(model_cfg, device="cpu", generator=gen)
    state = GANTrainState.create(g, d, train_cfg.g_optimizer(), train_cfg.d_optimizer())
    save_checkpoint(str(root), "exp", state)
    return flat, model_cfg


def _quant_keys(sampler):
    return {k for k in sampler.module.state_dict() if k.endswith(tquant.QUANT_BUFFERS)}


def test_load_model_inference_serves_biggan_in_int8(tmp_path, monkeypatch):
    """``quantize_serving`` on a native checkpoint: int8 buffers, images
    near the float ones; calibration on N(0, 1) features warns, on
    ``stored_features`` it does not; ``quant_calibration_images`` and
    ``quantize_dynamic`` are read (no dropped-key warning), and the latter
    warns on this backbone; with ``deploy_bf16`` the int8 G computes in
    bf16 and keeps its scales in float32."""
    flat, cfg = _native_checkpoint(tmp_path)
    rng = np.random.RandomState(0)
    z = rng.randn(4, cfg.effective_dim_z).astype(np.float32)
    f = rng.randn(4, cfg.instance_sz).astype(np.float32)
    fn, _ = tinf.load_model_inference(flat, device="cpu")
    assert not _quant_keys(fn)
    with pytest.warns(UserWarning, match=r"N\(0,1\)"):
        fq, _ = tinf.load_model_inference(dict(flat, quantize_serving=True), device="cpu")
    assert _quant_keys(fq)
    a, b = fn(z, None, f), fq(z, None, f)
    assert np.isfinite(b).all() and 0 < _rel(b, a) < 0.1

    seen = []
    real = tquant.quantize_variables
    monkeypatch.setattr(tquant, "quantize_variables",
                        lambda g, z, *a, **k: seen.append(z.shape[0]) or real(g, z, *a, **k))
    bank = str(tmp_path / "feats.npy")
    np.save(bank, rng.randn(10, cfg.instance_sz).astype(np.float32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fs, _ = tinf.load_model_inference(
            dict(flat, quantize_serving=True, quant_calibration_images=8, quantize_dynamic=True,
                 stored_features=bank), device="cpu")
    said = [str(w.message) for w in caught]
    assert seen == [8]
    assert any("StyleGAN2 backbone only" in m for m in said)
    assert not any("N(0,1)" in m or "would be dropped" in m for m in said), said
    assert 0 < _rel(fs(z, None, f), a) < 0.1

    with pytest.warns(UserWarning, match=r"N\(0,1\)"):
        fb, cfg_b = tinf.load_model_inference(
            dict(flat, quantize_serving=True, deploy_bf16=True), device="cpu")
    assert cfg_b.dtype == torch.bfloat16 and fb.module.blocks[0][0].conv1.dtype == torch.bfloat16
    sd = fb.module.state_dict()
    assert sd["blocks.0.0.conv1.qkernel"].dtype == torch.int8
    assert sd["blocks.0.0.conv1.wscale"].dtype == torch.float32
    assert sd["blocks.0.0.conv1.weight"].dtype == torch.bfloat16
    # Calibrated in float32 before the cast: the records are fq's.
    for k in _quant_keys(fq):
        assert torch.equal(sd[k], fq.module.state_dict()[k]), k
    assert 0 < _rel(fb(z, None, f), a) < 0.1


def test_load_model_inference_serves_stylegan2_in_int8(tf_pickle):  # noqa: F811
    """A StyleGAN2 network pickle: static per-channel int8, and with
    ``quantize_dynamic`` the ``act_dynamic`` markers; images within JAX's
    CLI bar of the float ones."""
    base = dict(backbone="stylegan2", network_pkl=tf_pickle, batch_size=4)
    fn, cfg = tinf.load_model_inference(base, device="cpu")
    fq, _ = tinf.load_model_inference(dict(base, quantize_serving=True), device="cpu")
    fd, _ = tinf.load_model_inference(dict(base, quantize_serving=True, quantize_dynamic=True),
                                      device="cpu")
    assert _quant_keys(fq) and not any(k.endswith("act_dynamic") for k in _quant_keys(fq))
    assert any(k.endswith("act_dynamic") for k in _quant_keys(fd))
    z = np.random.RandomState(0).randn(4, cfg.z_dim).astype(np.float32)
    a = fn(z)
    for f in (fq, fd):
        b = f(z)
        assert np.isfinite(b).all() and b.shape == a.shape
        assert 0 < _rel(b, a) < 0.15
