"""int8 serving: post-training quantization of a generator's convolutions.

Port of ``ic_gan_tpu/io/quant.py``, with its scheme:

- per-output-channel symmetric int8 weights (absmax / 127);
- per-conv, per-tensor activation scales from a calibration forward: the
  largest |input| over the calibration batch;
- exact int32 sums (``ops/int8_conv.py``), cast to the layer's compute type
  and dequantized there, the bias and what follows left as they were;
- the polyphase up-convs quantize their four 2×2 phase kernels, which are
  sums of the 3×3 kernel's taps (quantizing the 3×3 kernel first would
  round twice);
- ``down2x`` convs (the discriminator's) are left alone, and so are the
  attention blocks' θ/φ/g/o unless ``skip_attention=False``.

StyleGAN2 (``quantize_stylegan2_variables``): the modulated convs scale the
activations by the style, so their weights are as static as a plain conv's.
The activation scales are calibrated on the modulated input, per input
channel by default and folded into the weight before it is quantized; an
``up=2`` layer quantizes the four phase kernels of its weight composed with
the FIR filter; ``act_dynamic`` adds a per-sample range boost; ToRGB stays
float.

Where the JAX package adds a ``quant`` collection to the variables, the port
registers buffers on each quantized layer: ``act_scale``, ``qkernel``,
``wscale`` and, for the dynamic StyleGAN2 mode, the marker ``act_dynamic``.
A layer with them runs int8; ``drop_quant`` removes them, which gives the
float path back bit for bit.  Layouts are the port's: ``qkernel`` OIHW, an
``up2x`` conv's four phase kernels (4, O, I, 2, 2), a StyleGAN2 ``up=2``
layer's composite (4·O, I, 3, 3), phase major.  ``io/deploy.cast_params``
casts parameters only, so the int8 codes and their float32 scales stay as
they are.  Calibrate on the float32 weights, before that cast, as the JAX
package does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn

from ic_gan_tpu_torch.io.deploy import fold_spectral_norm
from ic_gan_tpu_torch.models import layers
from ic_gan_tpu_torch.models.layers import SelfAttention, SNConv
from ic_gan_tpu_torch.models.stylegan2 import SynthesisLayer
from ic_gan_tpu_torch.ops.conv_resample import _compose_kernel
from ic_gan_tpu_torch.ops.resample import polyphase_up_kernels

QUANT_BUFFERS = ("act_scale", "qkernel", "wscale", "act_dynamic")


def _quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW kernel: (qkernel int8,
    wscale float32 (O,)), in the JAX package's arithmetic."""
    w = w.to(torch.float32)
    s = torch.clamp_min(w.abs().amax(dim=tuple(range(1, w.dim()))) / 127.0, 1e-30)
    q = torch.clamp(torch.round(w / s.reshape(-1, *[1] * (w.dim() - 1))), -127, 127)
    return q.to(torch.int8), s


def _set_quant(layer: nn.Module, **buffers):
    for name, t in buffers.items():
        layer.register_buffer(name, t)


def drop_quant(module: nn.Module) -> nn.Module:
    """Remove every int8 buffer: the module serves its float path again."""
    for m in module.modules():
        for name in QUANT_BUFFERS:
            m._buffers.pop(name, None)
    return module


def load_quant_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Register int8 buffers from ``{"<layer>.<buffer>": tensor}`` (as
    ``io/convert.py`` carries the JAX ``quant`` collection across), each on
    its layer's device."""
    for key, t in state.items():
        prefix, name = key.rsplit(".", 1)
        if name not in QUANT_BUFFERS:
            raise KeyError(f"not an int8 buffer: {key}")
        layer = module.get_submodule(prefix)
        _set_quant(layer, **{name: t.to(layer.weight.device)})
    return module


def calibrate_conv_scales(g: nn.Module, *apply_args, **apply_kwargs) -> Dict[str, tuple]:
    """One forward ``g(*apply_args, **apply_kwargs)`` recording every
    ``SNConv``'s input absmax (in float32) and its resampling mode; returns
    ``{module name: (absmax, up2x, down2x)}``.  The attention's θ/φ/g fusion
    is off meanwhile, so that each of the three convs records its input."""
    convs = {name: m for name, m in g.named_modules() if isinstance(m, SNConv)}
    records: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(_, inputs):
            a = inputs[0].detach().float().abs().amax()
            records[name] = a if name not in records else torch.maximum(records[name], a)
        return record

    handles = [m.register_forward_pre_hook(hook(name)) for name, m in convs.items()]
    layers._ATTN_FUSION[0] = False
    try:
        with torch.no_grad():
            g(*apply_args, **apply_kwargs)
    finally:
        layers._ATTN_FUSION[0] = True
        for h in handles:
            h.remove()
    return {name: (float(a), convs[name].up2x, convs[name].down2x)
            for name, a in records.items()}


def quantize_variables(g: nn.Module, *calib_args, skip_attention: bool = True,
                       **apply_kwargs) -> nn.Module:
    """Fold spectral norm in ``g``, calibrate on one input
    ``g(*calib_args, **apply_kwargs)`` and give every conv the forward ran
    (but the ``down2x`` ones) its int8 buffers; returns ``g``.

    ``skip_attention`` (default True) leaves the attention blocks' θ/φ/g/o
    projections float: the block's work is in its two softmax products,
    which stay float either way."""
    fold_spectral_norm(g)
    scales = calibrate_conv_scales(g, *calib_args, **apply_kwargs)
    modules = dict(g.named_modules())
    attention = {f"{name}.{conv}" if name else conv
                 for name, m in modules.items() if isinstance(m, SelfAttention)
                 for conv in ("theta", "phi", "g", "o")}
    with torch.no_grad():
        for name, (absmax, up2x, down2x) in scales.items():
            if down2x or (skip_attention and name in attention):
                continue
            conv = modules[name]
            w = conv.weight.to(torch.float32)
            if up2x:
                qs = [_quantize_kernel(k) for k in polyphase_up_kernels(w)]
                qk = torch.stack([q for q, _ in qs])        # (4, O, I, 2, 2)
                ws = torch.stack([s for _, s in qs])        # (4, O)
            else:
                qk, ws = _quantize_kernel(w)
            act_scale = torch.tensor(max(absmax, 1e-30) / 127.0, dtype=torch.float32,
                                     device=w.device)
            _set_quant(conv, act_scale=act_scale, qkernel=qk, wscale=ws)
    return g


def quantize_stylegan2_variables(g: nn.Module, *calib_args, per_channel_act: bool = True,
                                 act_dynamic: bool = False, **apply_kwargs) -> nn.Module:
    """int8 serving for the StyleGAN2 generator: calibrate on one input
    ``g(*calib_args, **apply_kwargs)`` (e.g. ``noise_mode="const"``) and give
    each synthesis layer its int8 buffers; returns ``g``.

    - ``per_channel_act`` (default): the activation scale is a vector over
      the input channels, the modulated input's absmax per channel / 127,
      folded into the weight (conv(x, w) = conv(x/a, w·a)), so the
      dequantization stays per output channel.  Per-sample style modulation
      makes one per-tensor absmax starve most channels of int8 levels;
      ``False`` takes that per-tensor scale.
    - ``act_dynamic``: each sample's input is boosted into the full int8
      range at serving time and the output scaled back
      (``models/stylegan2.py:_modulated_conv_int8``).
    - ``up=2`` layers quantize the four phase kernels of the flipped weight
      composed with their FIR filter (``ops/conv_resample.py``), so the
      filtering runs inside the int8 conv and each tap is rounded once.
    - ToRGB is never quantized; a layer of another geometry stays float.
    """
    synth = {name: m for name, m in g.named_modules()
             if isinstance(m, SynthesisLayer) and m.quant() is None}
    for m in synth.values():
        m.quant_calib = torch.zeros(m.weight.shape[1], device=m.weight.device)
    try:
        with torch.no_grad():
            g(*calib_args, **apply_kwargs)
        calib = {name: m.quant_calib for name, m in synth.items()}
    finally:
        for m in synth.values():
            m.quant_calib = None
    with torch.no_grad():
        for name, layer in synth.items():
            absmax = calib[name].to(torch.float32)
            w = layer.weight.to(torch.float32)
            if per_channel_act:
                act_scale = torch.clamp_min(absmax, 1e-30) / 127.0
                w = w * act_scale[None, :, None, None]
            else:
                act_scale = torch.tensor(max(float(absmax.max()), 1e-30) / 127.0,
                                         dtype=torch.float32, device=w.device)
            if layer.up == 1:
                qk, ws = _quantize_kernel(w)
            elif layer.up == 2 and w.shape[2:] == (3, 3):
                f = layer.resample_filter(w.device)
                f2d = (torch.outer(f, f) if f.dim() == 1 else f) * 4.0
                k = _compose_kernel(w.flip(2, 3), f2d)                      # (O, I, 6, 6)
                qs = [_quantize_kernel(k[:, :, (3 - a) % 2::2, (3 - b) % 2::2])
                      for a in (0, 1) for b in (0, 1)]
                qk = torch.cat([q for q, _ in qs])                          # (4·O, I, 3, 3)
                ws = torch.stack([s for _, s in qs])                        # (4, O)
            else:
                continue
            _set_quant(layer, act_scale=act_scale, qkernel=qk, wscale=ws)
            if act_dynamic:
                _set_quant(layer, act_dynamic=torch.ones((), dtype=torch.int8,
                                                         device=w.device))
    return g
