"""BigGAN layers in PyTorch (NCHW): the generator's and the discriminator's.

Port of ``ic_gan_tpu/models/layers.py``, every ``norm_style`` of the
conditional batch norm included.  Module, parameter and buffer names follow
the upstream torch tree (``BigGAN_PyTorch/layers.py``), so ``state_dict()``
keys are the reference's: ``weight``/``bias``, spectral-norm state
``u0``/``sv0``, batch-norm statistics ``stored_mean``/``stored_var``.
``accum_counter`` (standing statistics) has no upstream counterpart and
carries the JAX buffer's name.

Each layer computes in its ``dtype`` (the model's compute type), casting its
input and weights to it, as the JAX layers do.  Folding spectral norm
(``io/deploy.fold_spectral_norm``) divides each weight by its σ once and
drops its ``u0``/``sv0`` buffers; a folded layer skips the power iteration.

``module.training`` plays the part of the JAX package's ``train=True``: a
spectrally normalized layer then advances ``u0``/``sv0`` at each forward, and
batch norm normalizes with the batch's moments while it updates its running
statistics.  State is updated in place, under ``no_grad``; σ itself stays on
the autograd tape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.icgan_ref.ops.attention import sagan_attention
from reference.icgan_ref.ops.resample import (
    avg_pool_2x,
    conv3x3_avg_pool_down,
    conv3x3_nearest_up,
    max_pool_2x,
    upsample_nearest_2x,
)
from reference.icgan_ref.ops.spectral_norm import spectral_normalize

# Reference argparse defaults (BigGAN_PyTorch/utils.py).
SN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _ortho(shape, device, generator) -> nn.Parameter:
    """Orthogonal init over the (out, fan_in) matricization, as the reference's
    ``init.orthogonal_`` (``BigGAN.py:327-345``)."""
    return nn.Parameter(
        nn.init.orthogonal_(torch.empty(shape, device=device), generator=generator))


# Reference init styles (``BigGAN.py:335-342``; argparse choices
# ``utils.py:302-315``); "ortho" is the construction default.
WEIGHT_INITS = {
    "N02": lambda w, gen: nn.init.normal_(w, 0.0, 0.02, generator=gen),
    "glorot": lambda w, gen: nn.init.xavier_uniform_(w, generator=gen),
    "xavier": lambda w, gen: nn.init.xavier_uniform_(w, generator=gen),
}


@torch.no_grad()
def apply_weight_init(module: nn.Module, style: str,
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every weight of a built BigGAN G or D in place, as the
    reference's ``init_weights`` overwrites every Conv2d/Linear/Embedding
    weight after building the tree (``BigGAN.py:294,326-345``): the
    ``weight`` of each linear, conv and embedding, G's ``shared`` table
    included (the JAX package's ``kernel``/``embedding``/``shared`` leaves);
    biases, batch-norm gains and attention gammas keep their values.
    ``style="ortho"`` is a no-op (the construction default).  Draws come
    from ``generator`` (on the module's device) or the default one."""
    if style == "ortho":
        return module
    init = WEIGHT_INITS[style]
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] == "weight":
            init(p, generator)
    return module


class _SpectralNormed(nn.Module):
    """A layer whose ``weight`` is divided by its top singular value, with the
    power-iteration state in buffers ``u0`` (num_svs, out) and ``sv0``;
    in training mode each forward advances that state."""

    def _init_sn(self, out_features, num_svs, num_itrs, eps, device, generator):
        self.num_itrs = num_itrs
        self.eps = eps
        self.register_buffer(
            "u0", torch.randn((num_svs, out_features), device=device, generator=generator))
        self.register_buffer("sv0", torch.ones(num_svs, device=device))

    @property
    def folded(self) -> bool:
        return "u0" not in self._buffers

    def w_bar(self) -> torch.Tensor:
        """The normalized weight in the weight's dtype; σ is found in float32
        or wider (the state ``u0`` stays float32 when the weights are cast to
        bf16).  In training mode the advanced state is copied into
        ``u0``/``sv0``: the σ on the tape holds the fresh tensor
        ``spectral_normalize`` returned, never the buffer, so a later forward
        before the backward is safe."""
        if self.folded:
            return self.weight
        w = self.weight.to(torch.promote_types(self.weight.dtype, torch.float32))
        w_bar, new_u, svs = spectral_normalize(
            w, self.u0, update=self.training,
            num_itrs=self.num_itrs, eps=self.eps)
        if self.training and new_u is not self.u0:
            with torch.no_grad():
                self.u0.copy_(new_u)
                self.sv0.copy_(svs)
        return w_bar.to(self.weight.dtype)

    @torch.no_grad()
    def fold_(self):
        """Bake σ into ``weight`` and drop the power-iteration state."""
        if not self.folded:
            self.weight.copy_(self.w_bar())
            del self.u0, self.sv0


class SNDense(_SpectralNormed):
    """Linear layer with spectral normalization (ref ``SNLinear``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 num_svs: int = 1, num_itrs: int = 1, eps: float = SN_EPS,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _ortho((out_features, in_features), device, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None
        self._init_sn(out_features, num_svs, num_itrs, eps, device, generator)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.w_bar().to(self.dtype), b)


class SNConv(_SpectralNormed):
    """k×k conv (stride 1, SAME padding) with spectral normalization (ref
    ``SNConv2d``).  ``up2x`` applies a 3×3 kernel as if the input were
    nearest-2×-upsampled, without the upsampled temp (``conv3x3_nearest_up``);
    ``down2x`` as if its output were 2×2-average-pooled, as one stride-2 conv
    (``conv3x3_avg_pool_down``)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int = 3,
                 bias: bool = True, up2x: bool = False, down2x: bool = False,
                 num_svs: int = 1, num_itrs: int = 1, eps: float = SN_EPS,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.up2x = up2x
        self.down2x = down2x
        self.padding = kernel_size // 2
        self.weight = _ortho((out_features, in_features, kernel_size, kernel_size),
                             device, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None
        self._init_sn(out_features, num_svs, num_itrs, eps, device, generator)

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.w_bar().to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.up2x:
            return conv3x3_nearest_up(x, w, b)
        if self.down2x:
            return conv3x3_avg_pool_down(x, w, b)
        return F.conv2d(x, w, b, padding=self.padding)


class SNEmbed(_SpectralNormed):
    """Embedding with spectral normalization over the (num_embeddings, dim)
    table (ref ``SNEmbedding``, ``layers.py:171-200``): the table is the
    (out, in) matrix, so ``u0`` has num_embeddings entries."""

    def __init__(self, num_embeddings: int, features: int, num_svs: int = 1,
                 num_itrs: int = 1, eps: float = SN_EPS,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _ortho((num_embeddings, features), device, generator)
        self._init_sn(num_embeddings, num_svs, num_itrs, eps, device, generator)

    def forward(self, idx):
        return F.embedding(idx, self.w_bar().to(self.dtype))


def _batch_norm(m: nn.Module, x, standing: bool):
    """Batch norm over ``m``'s ``stored_mean``/``stored_var``/``accum_counter``
    (``CrossReplicaBatchNorm``'s semantics)."""
    batch_moments = standing or m.training
    if batch_moments:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        v = xf.square().mean(dim=(0, 2, 3)) - mean.square()
        n = x.shape[0] * x.shape[2] * x.shape[3]
        bessel = n / max(n - 1, 1)
        with torch.no_grad():
            if standing:
                m.stored_mean += mean
                m.stored_var += v
                m.accum_counter += 1.0
            else:
                mom = BN_MOMENTUM
                m.stored_mean.copy_((1 - mom) * m.stored_mean + mom * mean)
                m.stored_var.copy_((1 - mom) * m.stored_var
                                   + mom * (v * bessel))
    else:
        cnt = m.accum_counter[0]
        use_standing = cnt > 0
        cnt = torch.clamp(cnt, min=1.0)
        mean = torch.where(use_standing, m.stored_mean / cnt, m.stored_mean)
        v = torch.where(use_standing, m.stored_var / cnt, m.stored_var)
    inv = torch.rsqrt(v + m.eps)
    if batch_moments or x.dtype == torch.float32:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return ((xf - mean[:, None, None]) * inv[:, None, None]).to(x.dtype)
    return (x - mean.to(x.dtype)[:, None, None]) * inv.to(x.dtype)[:, None, None]


def _instance_norm(m: nn.Module, x, batch_moments: bool):
    """Instance norm with running statistics (the ``in`` style, ref
    ``layers.py:421-431``, JAX ``InstanceNorm``): with ``batch_moments``
    each sample is normalized by its own (H, W) moments and the running
    statistics move toward their batch average (the variance unbiased over
    H·W); otherwise the running statistics normalize."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if batch_moments:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        v = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        with torch.no_grad():
            n = x.shape[2] * x.shape[3]
            mom = BN_MOMENTUM
            batch_mean, batch_v = mean.mean(dim=(0, 2, 3)), v.mean(dim=(0, 2, 3))
            m.stored_mean.copy_((1 - mom) * m.stored_mean + mom * batch_mean)
            m.stored_var.copy_((1 - mom) * m.stored_var
                               + mom * batch_v * (n / max(n - 1, 1)))
        out = (xf - mean) * torch.rsqrt(v + m.eps)
    else:
        out = ((xf - m.stored_mean[:, None, None])
               * torch.rsqrt(m.stored_var + m.eps)[:, None, None])
    return out.to(x.dtype)


def group_norm(x, norm_style: str, eps: float = BN_EPS):
    """Affine-free group norm with the reference's group choice (``groupnorm``,
    ``layers.py:340-351``): ``gn_ch_N`` → C//N groups, ``gn_grp_N`` → N
    groups, plain ``gn`` → 16, at most C and lowered until it divides C."""
    c = x.shape[1]
    if "ch" in norm_style:
        groups = max(c // int(norm_style.split("_")[-1]), 1)
    elif "grp" in norm_style:
        groups = int(norm_style.split("_")[-1])
    else:
        groups = 16
    groups = min(groups, c)
    while c % groups:
        groups -= 1
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    g = xf.reshape(x.shape[0], groups, c // groups, *x.shape[2:])
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    v = (g - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    return ((g - mean) * torch.rsqrt(v + eps)).reshape(x.shape).to(x.dtype)


def _check_norm_style(norm_style: str):
    if not (norm_style in ("bn", "in", "nonorm", "groupnorm") or norm_style.startswith("gn")):
        raise ValueError(f"unknown norm_style {norm_style!r}")


class CrossReplicaBatchNorm(nn.Module):
    """Parameter-free batch norm with torch ``F.batch_norm`` semantics.

    Training mode normalizes with the batch's mean and biased variance, taken
    in float32 as E[x²]−E[x]², and moves ``stored_mean``/``stored_var``
    toward the mean and the unbiased variance with momentum 0.1.  Standing
    mode adds the batch mean and biased variance to ``stored_mean`` and
    ``stored_var`` and counts in ``accum_counter``; eval then normalizes with
    the averages.  With a zero counter, eval uses the stored statistics as
    they are.  Statistics stay float32; a low-precision eval normalizes in the
    compute type (``layers.py:346-352`` of the JAX package).
    """

    def __init__(self, features: int, eps: float = BN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("stored_mean", torch.zeros(features, device=device))
        self.register_buffer("stored_var", torch.ones(features, device=device))
        self.register_buffer("accum_counter", torch.zeros(1, device=device))

    def forward(self, x, standing: bool = False):
        return _batch_norm(self, x, standing)


class ConditionalBatchNorm(nn.Module):
    """Class/instance-conditional batch norm (ref ``ccbn``): per-sample gain
    ``1 + gain(y)`` and bias ``bias(y)``, both spectrally normalized,
    bias-free linears, after a parameter-free normalization chosen by
    ``norm_style`` (ref ``layers.py:410-436``): ``bn`` (``CrossReplicaBatchNorm``'s,
    with its buffers), ``in`` (instance norm with running statistics
    ``stored_mean``/``stored_var``), ``gn``/``gn_ch_N``/``gn_grp_N`` (group
    norm, the reference's ``gn`` branch with its ``self.normstyle`` typo
    mended, as the JAX package has it) and ``nonorm``; the last two hold no
    statistics, as upstream."""

    def __init__(self, features: int, cond_features: int, eps: float = BN_EPS,
                 sn_eps: float = SN_EPS, num_svs: int = 1, num_itrs: int = 1,
                 norm_style: str = "bn", dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        super().__init__()
        _check_norm_style(norm_style)
        self.norm_style = norm_style
        self.eps = eps
        if norm_style in ("bn", "in"):
            self.register_buffer("stored_mean", torch.zeros(features, device=device))
            self.register_buffer("stored_var", torch.ones(features, device=device))
        if norm_style == "bn":
            self.register_buffer("accum_counter", torch.zeros(1, device=device))
        sn = dict(bias=False, num_svs=num_svs, num_itrs=num_itrs, eps=sn_eps,
                  dtype=dtype, device=device, generator=generator)
        self.gain = SNDense(cond_features, features, **sn)
        self.bias = SNDense(cond_features, features, **sn)

    def forward(self, x, y, standing: bool = False):
        gain = 1.0 + self.gain(y)
        bias = self.bias(y)
        style = self.norm_style
        if style == "bn":
            out = _batch_norm(self, x, standing)
        elif style == "in":
            out = _instance_norm(self, x, self.training or standing)
        elif style == "nonorm":
            out = x
        else:
            out = group_norm(x, style, eps=self.eps)
        return out * gain[:, :, None, None] + bias[:, :, None, None]


class ScaledBatchNorm(CrossReplicaBatchNorm):
    """Unconditional batch norm with learnable gain and bias (ref ``bn``),
    used by G's output layer."""

    def __init__(self, features: int, eps: float = BN_EPS, device=None):
        super().__init__(features, eps=eps, device=device)
        self.gain = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, standing: bool = False):
        out = super().forward(x, standing)
        return out * self.gain[:, None, None] + self.bias[:, None, None]


class SelfAttention(nn.Module):
    """SA-GAN non-local block (ref ``Attention``): 1×1 spectrally normalized
    θ/φ/g/o convs, φ and g 2×2 max-pooled, o = softmax(θφᵀ)·g through the
    attention kernel, output ``gamma * o(·) + x``."""

    def __init__(self, features: int, sn_eps: float = SN_EPS, num_svs: int = 1,
                 num_itrs: int = 1, dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        sn = dict(kernel_size=1, bias=False, num_svs=num_svs, num_itrs=num_itrs,
                  eps=sn_eps, dtype=dtype, device=device, generator=generator)
        self.theta = SNConv(features, features // 8, **sn)
        self.phi = SNConv(features, features // 8, **sn)
        self.g = SNConv(features, features // 2, **sn)
        self.o = SNConv(features // 2, features, **sn)
        self.gamma = nn.Parameter(torch.zeros((), device=device))

    def _fuses(self) -> bool:
        """θ/φ/g run as one 1×1 conv, one read of the input instead of three,
        once spectral norm is folded (an unfolded layer must divide each
        weight by its own σ)."""
        return all(c.folded for c in (self.theta, self.phi, self.g))

    def _fused_qkv_weight(self) -> Optional[torch.Tensor]:
        """θ|φ|g weights stacked for the fused conv, or None (``_fuses``)."""
        if not self._fuses():
            return None
        return torch.cat([self.theta.weight, self.phi.weight, self.g.weight])

    def _fused_qkv(self, x) -> Optional[torch.Tensor]:
        """θ|φ|g from the fused conv, or None."""
        if not self._fuses():
            return None
        return F.conv2d(x.to(self.dtype), self._fused_qkv_weight().to(self.dtype))

    def forward(self, x):
        n, _, h, w = x.shape
        c8, c2 = self.theta.weight.shape[0], self.g.weight.shape[0]
        fused = self._fused_qkv(x)
        if fused is not None:
            theta, phi, g = fused.split([c8, c8, c2], dim=1)
        else:
            theta, phi, g = self.theta(x), self.phi(x), self.g(x)
        phi, g = max_pool_2x(phi), max_pool_2x(g)
        # Token order h·W + w, as the JAX package's NHWC reshape.
        theta = theta.reshape(n, c8, h * w).transpose(1, 2).contiguous()
        phi = phi.reshape(n, c8, h * w // 4).transpose(1, 2).contiguous()
        g = g.reshape(n, c2, h * w // 4).transpose(1, 2).contiguous()
        o = sagan_attention(theta, phi, g)
        o = o.transpose(1, 2).reshape(n, c2, h, w)
        return self.gamma * self.o(o) + x


class GBlock(nn.Module):
    """Generator residual block (ref ``GBlock``): BN→ReLU→(up)conv3×3→BN→ReLU
    →conv3×3, plus a 1×1 shortcut.  The upsample is fused into conv1, and the
    shortcut conv runs before the upsample (they commute): both exact."""

    def __init__(self, in_features: int, out_features: int, cond_features: int,
                 upsample: bool = True, sn_eps: float = SN_EPS, bn_eps: float = BN_EPS,
                 num_svs: int = 1, num_itrs: int = 1, norm_style: str = "bn",
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.upsample = upsample
        sn = dict(num_svs=num_svs, num_itrs=num_itrs, dtype=dtype, device=device,
                  generator=generator)
        bn = dict(eps=bn_eps, sn_eps=sn_eps, norm_style=norm_style, **sn)
        self.bn1 = ConditionalBatchNorm(in_features, cond_features, **bn)
        self.conv1 = SNConv(in_features, out_features, 3, up2x=upsample, eps=sn_eps, **sn)
        self.bn2 = ConditionalBatchNorm(out_features, cond_features, **bn)
        self.conv2 = SNConv(out_features, out_features, 3, eps=sn_eps, **sn)
        self.conv_sc = None
        if in_features != out_features or upsample:
            self.conv_sc = SNConv(in_features, out_features, 1, eps=sn_eps, **sn)

    def forward(self, x, y, standing: bool = False):
        h = F.relu(self.bn1(x, y, standing))
        h = self.conv1(h)
        h = F.relu(self.bn2(h, y, standing))
        h = self.conv2(h)
        if self.conv_sc is not None:
            x = self.conv_sc(x)
        if self.upsample:
            x = upsample_nearest_2x(x)
        return h + x


class DBlock(nn.Module):
    """Discriminator residual block (ref ``DBlock``): (ReLU→)conv3×3→ReLU→
    conv3×3, the 2×2 average pool fused into conv2 (``down2x``), plus a
    shortcut.  The 1×1 shortcut conv commutes with the pool, so the shortcut
    pools first in both of the reference's orders (exact, 4× fewer FLOPs)."""

    def __init__(self, in_features: int, out_features: int, wide: bool = True,
                 preactivation: bool = True, downsample: bool = False,
                 sn_eps: float = SN_EPS, num_svs: int = 1, num_itrs: int = 1,
                 dtype: torch.dtype = torch.float32, device=None, generator=None):
        super().__init__()
        self.preactivation = preactivation
        self.downsample = downsample
        hidden = out_features if wide else in_features
        sn = dict(eps=sn_eps, num_svs=num_svs, num_itrs=num_itrs, dtype=dtype,
                  device=device, generator=generator)
        self.conv1 = SNConv(in_features, hidden, 3, **sn)
        self.conv2 = SNConv(hidden, out_features, 3, down2x=downsample, **sn)
        self.conv_sc = None
        if in_features != out_features or downsample:
            self.conv_sc = SNConv(in_features, out_features, 1, **sn)

    def forward(self, x):
        h = F.relu(x) if self.preactivation else x
        h = self.conv2(F.relu(self.conv1(h)))
        sc = avg_pool_2x(x) if self.downsample else x
        if self.conv_sc is not None:
            sc = self.conv_sc(sc)
        return h + sc
