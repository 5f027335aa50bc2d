"""BigGAN layers in PyTorch (NCHW): the generator's and the discriminator's.

Port of ``ic_gan_tpu/models/layers.py`` (``norm_style="bn"``).  Module,
parameter and buffer names follow the upstream torch tree
(``BigGAN_PyTorch/layers.py``), so ``state_dict()`` keys are the reference's:
``weight``/``bias``, spectral-norm state ``u0``/``sv0``, batch-norm
statistics ``stored_mean``/``stored_var``.  ``accum_counter`` (standing
statistics) has no upstream counterpart and carries the JAX buffer's name.

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

from ic_gan_tpu_torch.ops.attention import sagan_attention
from ic_gan_tpu_torch.ops.resample import (
    avg_pool_2x,
    conv3x3_avg_pool_down,
    conv3x3_nearest_up,
    max_pool_2x,
    upsample_nearest_2x,
)
from ic_gan_tpu_torch.ops.spectral_norm import spectral_normalize

# Reference argparse defaults (BigGAN_PyTorch/utils.py).
SN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _ortho(shape, device, generator) -> nn.Parameter:
    """Orthogonal init over the (out, fan_in) matricization, as the reference's
    ``init.orthogonal_`` (``BigGAN.py:327-345``)."""
    return nn.Parameter(
        nn.init.orthogonal_(torch.empty(shape, device=device), generator=generator))


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


class CrossReplicaBatchNorm(nn.Module):
    """Parameter-free batch norm with torch ``F.batch_norm`` semantics.

    Training mode normalizes with the batch's mean and biased variance, taken
    in float32 as E[x²]−E[x]², and moves ``stored_mean``/``stored_var``
    toward the mean and the unbiased variance with momentum 0.1.  Standing
    mode adds the batch mean and biased variance to ``stored_mean`` and
    ``stored_var`` and counts in ``accum_counter``; eval then normalizes with
    the averages.  With a zero counter, eval uses the stored statistics as
    they are.  Statistics stay float32; a low-precision eval normalizes in the
    compute type (``layers.py:346-352`` of the JAX package).  The moments are
    this process's batch only: cross-replica moments come with data
    parallelism (ROADMAP.md A.9).
    """

    def __init__(self, features: int, eps: float = BN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("stored_mean", torch.zeros(features, device=device))
        self.register_buffer("stored_var", torch.ones(features, device=device))
        self.register_buffer("accum_counter", torch.zeros(1, device=device))

    def forward(self, x, standing: bool = False):
        batch_moments = standing or self.training
        if batch_moments:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            v = xf.square().mean(dim=(0, 2, 3)) - mean.square()
            with torch.no_grad():
                if standing:
                    self.stored_mean += mean
                    self.stored_var += v
                    self.accum_counter += 1.0
                else:
                    n = x.shape[0] * x.shape[2] * x.shape[3]
                    mom = BN_MOMENTUM
                    self.stored_mean.copy_((1 - mom) * self.stored_mean + mom * mean)
                    self.stored_var.copy_((1 - mom) * self.stored_var
                                          + mom * (v * (n / max(n - 1, 1))))
        else:
            cnt = self.accum_counter[0]
            use_standing = cnt > 0
            cnt = torch.clamp(cnt, min=1.0)
            mean = torch.where(use_standing, self.stored_mean / cnt, self.stored_mean)
            v = torch.where(use_standing, self.stored_var / cnt, self.stored_var)
        inv = torch.rsqrt(v + self.eps)
        if batch_moments or x.dtype == torch.float32:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            return ((xf - mean[:, None, None]) * inv[:, None, None]).to(x.dtype)
        return (x - mean.to(x.dtype)[:, None, None]) * inv.to(x.dtype)[:, None, None]


class ConditionalBatchNorm(CrossReplicaBatchNorm):
    """Class/instance-conditional batch norm (ref ``ccbn``): per-sample gain
    ``1 + gain(y)`` and bias ``bias(y)``, both spectrally normalized,
    bias-free linears, after the parameter-free normalization."""

    def __init__(self, features: int, cond_features: int, eps: float = BN_EPS,
                 sn_eps: float = SN_EPS, num_svs: int = 1, num_itrs: int = 1,
                 norm_style: str = "bn", dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        if norm_style != "bn":
            raise NotImplementedError(
                f"norm_style {norm_style!r} is not ported yet (ROADMAP.md A.3); "
                "only 'bn' is")
        super().__init__(features, eps=eps, device=device)
        sn = dict(bias=False, num_svs=num_svs, num_itrs=num_itrs, eps=sn_eps,
                  dtype=dtype, device=device, generator=generator)
        self.gain = SNDense(cond_features, features, **sn)
        self.bias = SNDense(cond_features, features, **sn)

    def forward(self, x, y, standing: bool = False):
        gain = 1.0 + self.gain(y)
        bias = self.bias(y)
        out = super().forward(x, standing)
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

    def _fused_qkv_weight(self) -> Optional[torch.Tensor]:
        """θ|φ|g weights stacked for one 1×1 conv: one read of the input
        instead of three.  Only once spectral norm is folded; an unfolded
        layer must divide each weight by its own σ, so it gets None."""
        if not (self.theta.folded and self.phi.folded and self.g.folded):
            return None
        return torch.cat([self.theta.weight, self.phi.weight, self.g.weight])

    def forward(self, x):
        n, _, h, w = x.shape
        c8, c2 = self.theta.weight.shape[0], self.g.weight.shape[0]
        wf = self._fused_qkv_weight()
        if wf is not None:
            theta, phi, g = F.conv2d(x.to(self.dtype), wf.to(self.dtype)).split(
                [c8, c8, c2], dim=1)
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
