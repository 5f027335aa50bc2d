"""StyleGAN2-ADA generator and discriminator with IC-GAN instance
conditioning, in PyTorch (NCHW).

Port of ``ic_gan_tpu/models/stylegan2.py`` (reference
``stylegan2_ada_pytorch/training/networks.py``).  Module, parameter and
buffer names are the JAX package's, which are upstream's: ``mapping.fc{i}``,
``mapping.embed_feats``, ``mapping.w_avg``, ``synthesis.b{res}.const``,
``synthesis.b{res}.conv0/conv1/torgb`` with ``affine``, ``weight``, ``bias``,
``noise_strength`` and ``noise_const``; in D ``b{res}.fromrgb/skip/conv0/
conv1`` and ``b4.conv/fc/out``.  Layouts are OIHW convs and (out, in)
linears; equalized-lr gains are applied at run time, the weights stored
unscaled.

Compute types follow the JAX modules: a block in ``num_fp16_res`` computes
in bf16, the rest in float32, or in the input's type when that is wider
(float64 in the tests), never narrower (``_f32p``).  ``modulated_conv2d`` is
the unfused formulation (scale the activations, convolve, demodulate).  Every
bias and activation goes through ``ops.bias_act.bias_act``, so on the card
they launch the fused kernel.  Layer noise takes an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.ops.bias_act import activation_funcs, bias_act
from ic_gan_tpu_torch.ops.conv_resample import conv2d_resample, is_symmetric
from ic_gan_tpu_torch.ops.resample import downsample2d, setup_filter, upsample2d

SQRT_HALF = math.sqrt(0.5)


def normalize_2nd_moment(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def _f32p(x: torch.Tensor) -> torch.Tensor:
    """At least float32: promote, never demote (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _randn(shape, std, device, generator):
    return torch.randn(shape, device=device, generator=generator) * std


class _Filtered(nn.Module):
    """A module with a FIR resample filter: a constant of the architecture,
    not a weight nor a buffer (a buffer would be left unset by
    ``skip_init`` and ``load_state_dict``).  Its copy on each device is made
    once, at the first call there; whether it is symmetric is read once."""

    def _init_filter(self, resample_filter):
        self._filter_cpu = setup_filter(list(resample_filter))
        self._filter_on = {}
        self.f_symmetric = is_symmetric(self._filter_cpu)

    def resample_filter(self, device) -> torch.Tensor:
        f = self._filter_on.get(device)
        if f is None:
            f = self._filter_on[device] = self._filter_cpu.to(device)
        return f


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                     padding: int = 0, resample_filter: Optional[torch.Tensor] = None,
                     demodulate: bool = True, flip_weight: bool = True,
                     f_symmetric: Optional[bool] = None) -> torch.Tensor:
    """Style modulation, conv and demodulation (ref ``networks.py:37-117``).
    x (N, I, H, W), weight (O, I, kh, kw), styles (N, I); noise broadcasts
    to the output."""
    out_ch, in_ch, kh, kw = weight.shape
    if x.dtype == torch.bfloat16 and demodulate:
        # Pre-normalize against low-precision overflow (ref :56-63); it
        # cancels between the conv and the demodulation coefficients.
        weight = weight * (1.0 / math.sqrt(in_ch * kh * kw)
                           / weight.abs().amax(dim=(1, 2, 3), keepdim=True))
        styles = styles / styles.abs().amax(dim=-1, keepdim=True)
    dcoefs = None
    if demodulate:
        w2 = _f32p(weight).square().sum(dim=(2, 3))                       # (O, I)
        dcoefs = torch.rsqrt(_f32p(styles).square() @ w2.T + 1e-8)        # (N, O)
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight, f_symmetric=f_symmetric)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class FullyConnected(nn.Module):
    """Equalized-lr dense layer (ref ``FullyConnectedLayer``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, device=None, generator=None):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(_randn((out_features, in_features), 1.0 / lr_multiplier,
                                          device, generator))
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init), device=device)) \
            if bias else None

    def forward(self, x):
        y = x @ (self.weight.to(x.dtype) * self.weight_gain).T
        b = None
        if self.bias is not None:
            b = self.bias.to(x.dtype)
            if self.lr_multiplier != 1.0:
                b = b * self.lr_multiplier
        return bias_act(y, b, dim=1, act=self.activation)


class Conv2d(_Filtered):
    """Equalized-lr conv with optional up/down (ref ``Conv2dLayer``).  The
    compute type comes from the caller, as the JAX block sets it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, device=None, generator=None):
        super().__init__()
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(_randn((out_channels, in_channels, kernel_size, kernel_size),
                                          1.0, device, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None
        self._init_filter(resample_filter)

    def forward(self, x, gain: float = 1.0, dtype: torch.dtype = torch.float32):
        w = self.weight * self.weight_gain
        x = conv2d_resample(x.to(dtype), w.to(dtype), f=self.resample_filter(x.device),
                            up=self.up, down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1), f_symmetric=self.f_symmetric)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, None if self.bias is None else self.bias.to(x.dtype), dim=1,
                        act=self.activation,
                        gain=activation_funcs[self.activation].def_gain * gain, clamp=clamp)


class MappingNetwork(nn.Module):
    """z/c/h → w with the IC-GAN instance path (ref ``networks.py:238-354``)."""

    def __init__(self, z_dim: int, c_dim: int, h_dim: int, w_dim: int,
                 num_ws: Optional[int], num_layers: int = 8,
                 embed_features: Optional[int] = None,
                 embed_features_feat: Optional[int] = None,
                 layer_features: Optional[int] = None, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, w_avg_beta: Optional[float] = 0.995,
                 device=None, generator=None):
        super().__init__()
        self.z_dim, self.c_dim, self.h_dim, self.w_dim = z_dim, c_dim, h_dim, w_dim
        self.num_ws, self.num_layers, self.w_avg_beta = num_ws, num_layers, w_avg_beta
        embed_features = embed_features or w_dim
        embed_features_feat = embed_features_feat or w_dim
        layer_features = layer_features or w_dim
        kw = dict(device=device, generator=generator)
        features = z_dim
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, embed_features, **kw)
            features += embed_features
        if h_dim > 0:
            self.embed_feats = FullyConnected(h_dim, embed_features_feat, **kw)
            features += embed_features_feat
        for idx in range(num_layers):
            out = layer_features if idx < num_layers - 1 else w_dim
            setattr(self, f"fc{idx}", FullyConnected(
                features, out, activation=activation, lr_multiplier=lr_multiplier, **kw))
            features = out
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def forward(self, z, c=None, h=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None, update_w_avg: bool = False):
        """``update_w_avg`` moves ``w_avg`` toward this batch's mean w (the
        JAX ``train=True``)."""
        parts = []
        if self.z_dim > 0:
            parts.append(normalize_2nd_moment(_f32p(z)))
        embeds = []
        if self.c_dim > 0:
            embeds.append(self.embed(_f32p(c)))
        if self.h_dim > 0:
            embeds.append(self.embed_feats(_f32p(h)))
        if embeds:
            parts.append(normalize_2nd_moment(torch.cat(embeds, dim=-1)))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        w_avg = getattr(self, "w_avg", None)
        if update_w_avg and w_avg is not None:
            with torch.no_grad():
                mean_w = x.detach().mean(dim=0)
                w_avg.copy_(mean_w + (w_avg - mean_w) * self.w_avg_beta)
        if self.num_ws is not None:
            x = x[:, None, :].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if w_avg is None:
                raise ValueError("truncation needs w_avg: a mapping with num_ws and w_avg_beta")
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + (x - w_avg) * truncation_psi
            else:
                head = w_avg + (x[:, :truncation_cutoff] - w_avg) * truncation_psi
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class SynthesisLayer(_Filtered):
    """Modulated conv, noise, bias and activation (ref ``networks.py:360-444``)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, device=None, generator=None):
        super().__init__()
        self.resolution, self.up, self.use_noise = resolution, up, use_noise
        self.activation, self.conv_clamp = activation, conv_clamp
        self.padding = kernel_size // 2
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device,
                                     generator=generator)
        self.weight = nn.Parameter(_randn((out_channels, in_channels, kernel_size,
                                           kernel_size), 1.0, device, generator))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros((), device=device))
            self.register_buffer("noise_const", _randn((resolution, resolution), 1.0,
                                                        device, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self._init_filter(resample_filter)

    def forward(self, x, w, noise_mode: str = "random", gain: float = 1.0, generator=None):
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be random, const or none, got {noise_mode!r}")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            noise = torch.randn((x.shape[0], 1, self.resolution, self.resolution),
                                device=x.device, generator=generator,
                                dtype=_f32p(w).dtype) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, None]
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter(x.device),
                             flip_weight=(self.up == 1), f_symmetric=self.f_symmetric)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), dim=1, act=self.activation,
                        gain=activation_funcs[self.activation].def_gain * gain, clamp=clamp)


class ToRGB(nn.Module):
    """1×1 modulated conv to image channels (ref ``networks.py:453-486``)."""

    def __init__(self, in_channels: int, img_channels: int, w_dim: int,
                 conv_clamp: Optional[float] = None, device=None, generator=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device,
                                     generator=generator)
        self.weight = nn.Parameter(_randn((img_channels, in_channels, 1, 1), 1.0, device,
                                          generator))
        self.bias = nn.Parameter(torch.zeros(img_channels, device=device))

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), dim=1, clamp=self.conv_clamp)


class SynthesisBlock(_Filtered):
    """One resolution of the synthesis network (ref ``networks.py:492-618``)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, is_last: bool, architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.in_channels, self.architecture = in_channels, architecture
        self.is_last, self.use_fp16 = is_last, use_fp16
        kw = dict(device=device, generator=generator)
        layer = dict(w_dim=w_dim, resolution=resolution, resample_filter=resample_filter,
                     conv_clamp=conv_clamp, **kw)
        if in_channels == 0:
            self.const = nn.Parameter(_randn((out_channels, resolution, resolution), 1.0,
                                             device, generator))
        else:
            if architecture == "resnet":
                self.skip = Conv2d(in_channels, out_channels, kernel_size=1, bias=False,
                                   up=2, resample_filter=resample_filter, **kw)
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **layer)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **layer)
        if self.num_torgb:
            self.torgb = ToRGB(out_channels, img_channels, w_dim, conv_clamp=conv_clamp, **kw)
        self._init_filter(resample_filter)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    @property
    def num_torgb(self) -> int:
        return 1 if (self.is_last or self.architecture == "skip") else 0

    def forward(self, x, img, ws, noise_mode: str = "random", force_fp32: bool = False,
                generator=None):
        dtype = (torch.bfloat16 if (self.use_fp16 and not force_fp32)
                 else torch.promote_types(ws.dtype, torch.float32))
        w_iter = iter(ws.unbind(dim=1))
        kw = dict(noise_mode=noise_mode, generator=generator)
        if self.in_channels == 0:
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, next(w_iter), **kw)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=SQRT_HALF, dtype=dtype)
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), gain=SQRT_HALF, **kw)
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), **kw)
        if img is not None:
            img = upsample2d(img, self.resample_filter(img.device))
        if self.num_torgb:
            y = _f32p(self.torgb(x, next(w_iter)))
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """Blocks from 4×4 up to ``img_resolution`` (ref ``networks.py:625-703``)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 0,
                 architecture: str = "skip", conv_clamp: Optional[float] = None,
                 device=None, generator=None):
        super().__init__()
        self.img_resolution = img_resolution
        self.block_resolutions = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
        channels = lambda res: min(channel_base // res, channel_max)  # noqa: E731
        fp16_res = max(2 ** (int(math.log2(img_resolution)) + 1 - num_fp16_res), 8)
        self.num_ws = 0
        for res in self.block_resolutions:
            block = SynthesisBlock(
                0 if res == 4 else channels(res // 2), channels(res), w_dim=w_dim,
                resolution=res, img_channels=img_channels, is_last=(res == img_resolution),
                architecture=architecture, conv_clamp=conv_clamp,
                use_fp16=(res >= fp16_res and num_fp16_res > 0), device=device,
                generator=generator)
            setattr(self, f"b{res}", block)
            self.num_ws += block.num_conv
        self.num_ws += 1  # the last block's torgb

    def forward(self, ws, noise_mode: str = "random", force_fp32: bool = False,
                generator=None):
        ws = _f32p(ws)
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            # A skip block's torgb reuses the next block's first w (ref
            # networks.py:669-675): the index advances by num_conv only.
            block_ws = ws[:, w_idx:w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, block_ws, noise_mode=noise_mode, force_fp32=force_fp32,
                           generator=generator)
            w_idx += block.num_conv
        return img


@dataclasses.dataclass(frozen=True)
class StyleGAN2Config:
    """Generator and discriminator hyperparameters, as the JAX package's."""

    img_resolution: int = 256
    img_channels: int = 3
    z_dim: int = 512
    c_dim: int = 0       # one-hot class dim (0 = unconditional)
    h_dim: int = 2048    # instance-feature dim (IC-GAN)
    w_dim: int = 512
    channel_base: int = 32768
    channel_max: int = 512
    num_mapping_layers: int = 8
    num_fp16_res: int = 4
    conv_clamp: Optional[float] = 256.0
    architecture_g: str = "skip"
    architecture_d: str = "resnet"
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class Generator(nn.Module):
    """Mapping and synthesis (ref ``networks.py:710-757``)."""

    def __init__(self, cfg: StyleGAN2Config, device=None, generator=None):
        """On CUDA unless ``device`` names another (``resolve_device``)."""
        super().__init__()
        self.cfg = cfg
        kw = dict(device=resolve_device(device), generator=generator)
        self.synthesis = SynthesisNetwork(
            w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
            img_channels=cfg.img_channels, channel_base=cfg.channel_base,
            channel_max=cfg.channel_max, num_fp16_res=cfg.num_fp16_res,
            architecture=cfg.architecture_g, conv_clamp=cfg.conv_clamp, **kw)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=cfg.c_dim, h_dim=cfg.h_dim, w_dim=cfg.w_dim,
            num_ws=self.synthesis.num_ws, num_layers=cfg.num_mapping_layers, **kw)

    def forward(self, z, c=None, feats=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None, noise_mode: str = "random",
                update_w_avg: bool = False, force_fp32: bool = False, generator=None):
        ws = self.map_ws(z, c, feats, truncation_psi=truncation_psi,
                         truncation_cutoff=truncation_cutoff, update_w_avg=update_w_avg)
        return self.synthesize(ws, noise_mode=noise_mode, force_fp32=force_fp32,
                               generator=generator)

    def map_ws(self, z, c=None, feats=None, update_w_avg: bool = False, **kw):
        return self.mapping(z, c, feats, update_w_avg=update_w_avg, **kw)

    def synthesize(self, ws, noise_mode: str = "random", force_fp32: bool = False,
                   generator=None):
        """ws (N, num_ws, w_dim) → images (N, C, H, W), float32 or wider."""
        return self.synthesis(ws, noise_mode=noise_mode, force_fp32=force_fp32,
                              generator=generator)


def minibatch_std(x: torch.Tensor, group_size: Optional[int] = 4,
                  num_channels: int = 1) -> torch.Tensor:
    """Minibatch standard-deviation channels (ref ``networks.py:900-927``)."""
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    y = _f32p(x.reshape(g, n // g, f, c // f, h, w))
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))                                   # (n/g, F)
    y = y.repeat(g, 1)[:, :, None, None].expand(n, f, h, w)     # tiled over groups
    return torch.cat([x, y.to(x.dtype)], dim=1)


class DiscriminatorBlock(_Filtered):
    """(ref ``networks.py:762-889``)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, architecture: str = "resnet",
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.in_channels, self.architecture, self.use_fp16 = in_channels, architecture, use_fp16
        kw = dict(resample_filter=resample_filter, device=device, generator=generator)
        act = dict(activation=activation, conv_clamp=conv_clamp)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2d(img_channels, tmp_channels, kernel_size=1, **act, **kw)
        if architecture == "resnet":
            self.skip = Conv2d(tmp_channels, out_channels, kernel_size=1, bias=False, down=2,
                               **kw)
        self.conv0 = Conv2d(tmp_channels, tmp_channels, kernel_size=3, **act, **kw)
        self.conv1 = Conv2d(tmp_channels, out_channels, kernel_size=3, down=2, **act, **kw)
        self._init_filter(resample_filter)

    def forward(self, x, img, force_fp32: bool = False):
        base = img.dtype if img is not None else x.dtype
        dtype = (torch.bfloat16 if (self.use_fp16 and not force_fp32)
                 else torch.promote_types(base, torch.float32))
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img, dtype=dtype)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter(img.device))
                   if self.architecture == "skip" else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=SQRT_HALF, dtype=dtype)
            x = self.conv0(x, dtype=dtype)
            x = self.conv1(x, gain=SQRT_HALF, dtype=dtype)
            x = y + x
        else:
            x = self.conv0(x, dtype=dtype)
            x = self.conv1(x, dtype=dtype)
        return x, img


class DiscriminatorEpilogue(nn.Module):
    """(ref ``networks.py:934-1006``)."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int = 4,
                 img_channels: int = 3, architecture: str = "resnet",
                 mbstd_group_size: Optional[int] = 4, mbstd_num_channels: int = 1,
                 activation: str = "lrelu", conv_clamp: Optional[float] = None,
                 device=None, generator=None):
        super().__init__()
        self.cmap_dim, self.architecture = cmap_dim, architecture
        self.mbstd_group_size, self.mbstd_num_channels = mbstd_group_size, mbstd_num_channels
        kw = dict(device=device, generator=generator)
        if architecture == "skip":
            self.fromrgb = Conv2d(img_channels, in_channels, kernel_size=1,
                                  activation=activation, **kw)
        self.conv = Conv2d(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                           activation=activation, conv_clamp=conv_clamp, **kw)
        self.fc = FullyConnected(in_channels * resolution ** 2, in_channels,
                                 activation=activation, **kw)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim, **kw)

    def forward(self, x, img, cmap):
        x = _f32p(x)
        if self.architecture == "skip":
            x = x + self.fromrgb(_f32p(img), dtype=x.dtype)
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x, dtype=x.dtype)
        x = self.fc(x.flatten(1))     # (C, H, W) order, as the JAX package flattens
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=-1, keepdim=True) * (1.0 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """(ref ``networks.py:1015-1101``)."""

    def __init__(self, cfg: StyleGAN2Config, device=None, generator=None):
        """On CUDA unless ``device`` names another (``resolve_device``)."""
        super().__init__()
        self.cfg = cfg
        kw = dict(device=resolve_device(device), generator=generator)
        res_log2 = int(math.log2(cfg.img_resolution))
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = {res: min(cfg.channel_base // res, cfg.channel_max)
                    for res in self.block_resolutions + [4]}
        fp16_res = max(2 ** (res_log2 + 1 - cfg.num_fp16_res), 8)
        cmap_dim = channels[4] if (cfg.c_dim > 0 or cfg.h_dim > 0) else 0
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels[res] if res < cfg.img_resolution else 0, channels[res],
                channels[res // 2], resolution=res, img_channels=cfg.img_channels,
                architecture=cfg.architecture_d, conv_clamp=cfg.conv_clamp,
                use_fp16=(res >= fp16_res and cfg.num_fp16_res > 0), **kw))
        if cmap_dim > 0:
            self.mapping = MappingNetwork(
                z_dim=0, c_dim=cfg.c_dim, h_dim=cfg.h_dim, w_dim=cmap_dim, num_ws=None,
                w_avg_beta=None, num_layers=cfg.num_mapping_layers, **kw)
        self.b4 = DiscriminatorEpilogue(
            channels[4], cmap_dim=cmap_dim, img_channels=cfg.img_channels,
            architecture=cfg.architecture_d, mbstd_group_size=cfg.mbstd_group_size,
            mbstd_num_channels=cfg.mbstd_num_channels, conv_clamp=cfg.conv_clamp, **kw)

    def forward(self, img, c=None, feats=None, force_fp32: bool = False):
        """img (N, C, H, W) → logits (N, 1), float32 or wider."""
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c, feats) if hasattr(self, "mapping") else None
        return self.b4(x, img, cmap)
