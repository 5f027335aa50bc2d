"""BigGAN-deep generator and discriminator in PyTorch (NCHW).

Port of ``ic_gan_tpu/models/biggan_deep.py`` (``deep_d_arch``,
``BigGANDeepConfig``, ``DeepGBlock``, ``DeepDBlock``, ``Generator``,
``Discriminator``; upstream ``BigGAN_PyTorch/BigGANdeep.py``): bottleneck
residual blocks of four convs (channel ratio 4), a channel-drop shortcut in G
and a channel-concat shortcut in D, z joined to the conditioning once (no
z chunks), ``G_depth``/``D_depth`` blocks a stage, and a stem conv in D.
The IC-GAN instance conditioning (``shared_feat``, ``linear_feat``) is the
JAX package's extension, as there.

Module names follow the upstream torch tree, so ``state_dict()`` keys are
the reference's: G ``shared``, ``shared_feat``, ``linear``,
``blocks.{stage·G_depth + g}.0`` (a block), ``blocks.{stage·G_depth +
G_depth − 1}.1`` (the stage's attention), ``output_layer.0`` (batch norm),
``output_layer.2`` (conv); D ``input_conv``, ``blocks.{stage}.{d}`` (a
block), ``blocks.{stage}.{D_depth}`` (attention), ``linear``, ``embed``,
``linear_feat``.  ``module.train()`` is the JAX package's ``train=True``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.models.biggan import BigGANConfig, _attn_set
from ic_gan_tpu_torch.models.layers import (
    BN_EPS,
    SN_EPS,
    ConditionalBatchNorm,
    ScaledBatchNorm,
    SelfAttention,
    SNConv,
    SNDense,
    SNEmbed,
    _ortho,
)
from ic_gan_tpu_torch.ops.resample import avg_pool_2x, upsample_nearest_2x


def deep_d_arch(resolution: int, ch: int, attention: str = "64") -> Dict[str, Any]:
    """Discriminator channel table (ref ``BigGANdeep.py:472-...``): no
    leading 3-channel entry, the stem conv maps RGB to ``in_channels[0]``."""
    tables = {
        256: ([1, 2, 4, 8, 8, 16], [2, 4, 8, 8, 16, 16], 6, [128, 64, 32, 16, 8, 4, 4]),
        128: ([1, 2, 4, 8, 16], [2, 4, 8, 16, 16], 5, [64, 32, 16, 8, 4, 4]),
        64: ([1, 2, 4, 8], [2, 4, 8, 16], 4, [32, 16, 8, 4, 4]),
        32: ([4, 4, 4], [4, 4, 4], 2, [16, 16, 16]),
    }
    cin_m, cout_m, n_down, res = tables[resolution]
    attn = set(_attn_set(attention))
    return {
        "in_channels": [ch * m for m in cin_m],
        "out_channels": [ch * m for m in cout_m],
        "downsample": [True] * n_down + [False] * (len(cout_m) - n_down),
        "resolution": res,
        "attention": [r in attn for r in res[:len(cout_m)]],
    }


@dataclasses.dataclass(frozen=True)
class BigGANDeepConfig(BigGANConfig):
    """The deep variant's knobs over the base config, at the reference's
    defaults: dim_z 128, ``G_depth`` = ``D_depth`` = 2, class-conditional.
    z is read whole (one slot, no chunks)."""

    dim_z: int = 128
    G_depth: int = 2
    D_depth: int = 2
    class_cond: bool = True
    instance_cond: bool = False
    channel_ratio: int = 4

    @property
    def d_arch(self):
        return deep_d_arch(self.resolution, self.D_ch, self.D_attn)

    @property
    def num_slots(self) -> int:
        return 1

    @property
    def z_chunk_size(self) -> int:
        return 0

    @property
    def effective_dim_z(self) -> int:
        return self.dim_z


class DeepGBlock(nn.Module):
    """Bottleneck G block (ref ``BigGANdeep.py:33-84``): CBN→ReLU→1×1 conv,
    CBN→ReLU→3×3 conv (the upsample fused into it), CBN→ReLU→3×3 conv,
    CBN→ReLU→1×1 conv, plus the input with its extra channels dropped
    (nearest-upsampled when the block upsamples)."""

    def __init__(self, in_features: int, out_features: int, cond_features: int,
                 upsample: bool, channel_ratio: int = 4, sn_eps: float = SN_EPS,
                 bn_eps: float = BN_EPS, num_svs: int = 1, num_itrs: int = 1,
                 norm_style: str = "bn", dtype: torch.dtype = torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.out_features = out_features
        self.upsample = upsample
        hidden = in_features // channel_ratio
        sn = dict(eps=sn_eps, num_svs=num_svs, num_itrs=num_itrs, dtype=dtype,
                  device=device, generator=generator)
        bn = dict(eps=bn_eps, sn_eps=sn_eps, num_svs=num_svs, num_itrs=num_itrs,
                  norm_style=norm_style, dtype=dtype, device=device, generator=generator)
        self.bn1 = ConditionalBatchNorm(in_features, cond_features, **bn)
        self.conv1 = SNConv(in_features, hidden, 1, **sn)
        self.bn2 = ConditionalBatchNorm(hidden, cond_features, **bn)
        self.conv2 = SNConv(hidden, hidden, 3, up2x=upsample, **sn)
        self.bn3 = ConditionalBatchNorm(hidden, cond_features, **bn)
        self.conv3 = SNConv(hidden, hidden, 3, **sn)
        self.bn4 = ConditionalBatchNorm(hidden, cond_features, **bn)
        self.conv4 = SNConv(hidden, out_features, 1, **sn)

    def forward(self, x, y, standing: bool = False):
        h = self.conv1(F.relu(self.bn1(x, y, standing)))
        h = self.conv2(F.relu(self.bn2(h, y, standing)))
        h = self.conv3(F.relu(self.bn3(h, y, standing)))
        h = self.conv4(F.relu(self.bn4(h, y, standing)))
        x = x[:, :self.out_features]  # channel drop (ref :73-74)
        if self.upsample:
            x = upsample_nearest_2x(x)
        return h + x


class DeepDBlock(nn.Module):
    """Bottleneck D block (ref ``BigGANdeep.py:394-450``): ReLU→1×1 conv,
    ReLU→3×3, ReLU→3×3, ReLU, the 2×2 average pool, 1×1 conv; the shortcut
    pools the input and appends ``conv_sc``'s extra channels to it."""

    def __init__(self, in_features: int, out_features: int, downsample: bool,
                 channel_ratio: int = 4, sn_eps: float = SN_EPS, num_svs: int = 1,
                 num_itrs: int = 1, dtype: torch.dtype = torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.downsample = downsample
        hidden = out_features // channel_ratio
        sn = dict(eps=sn_eps, num_svs=num_svs, num_itrs=num_itrs, dtype=dtype,
                  device=device, generator=generator)
        self.conv1 = SNConv(in_features, hidden, 1, **sn)
        self.conv2 = SNConv(hidden, hidden, 3, **sn)
        self.conv3 = SNConv(hidden, hidden, 3, **sn)
        self.conv4 = SNConv(hidden, out_features, 1, **sn)
        self.conv_sc = None
        if in_features != out_features:
            self.conv_sc = SNConv(in_features, out_features - in_features, 1, **sn)

    def forward(self, x):
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        h = F.relu(self.conv3(F.relu(h)))
        sc = x
        if self.downsample:
            h, sc = avg_pool_2x(h), avg_pool_2x(sc)
        h = self.conv4(h)
        if self.conv_sc is not None:
            sc = torch.cat([sc, self.conv_sc(sc)], dim=1)
        return h + sc


class Generator(nn.Module):
    """BigGAN-deep generator.

    ``forward(z, label=None, feats=None, standing=False)``: z (N, dim_z),
    label (N,) when ``class_cond``, feats (N, instance_sz) when
    ``instance_cond`` → images (N, 3, res, res), float32 in [-1, 1].  With
    ``hier`` the conditioning [class, feat] and z are joined once and feed
    the stem and every block's batch norms.  Runs on ``device`` (default
    CUDA), weights drawn from ``generator``; built in eval mode.  Build with
    ``torch.nn.utils.skip_init(Generator, cfg, device=...)`` to skip the
    initializers before ``load_state_dict``.
    """

    def __init__(self, cfg: BigGANDeepConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        arch = cfg.g_arch
        sn = dict(num_svs=cfg.num_G_SVs, num_itrs=cfg.num_SV_itrs, dtype=cfg.dtype,
                  device=device, generator=generator)
        cond = 0
        if cfg.class_cond:
            width = cfg.shared_dim_eff
            self.shared = nn.Embedding(cfg.n_classes, width, device=device,
                                       _weight=_ortho((cfg.n_classes, width), device, generator))
            cond = width
        if cfg.instance_cond:
            self.shared_feat = SNDense(cfg.instance_sz, cfg.shared_dim_feat, eps=cfg.SN_eps, **sn)
            cond += cfg.shared_dim_feat
        self.joined = cfg.hier and cond > 0
        if self.joined:
            cond += cfg.dim_z
        self.linear = SNDense(cond if self.joined else cfg.dim_z,
                              arch["in_channels"][0] * cfg.bottom_width ** 2,
                              eps=cfg.SN_eps, **sn)
        blocks = []
        for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
            for d in range(cfg.G_depth):
                last = d == cfg.G_depth - 1
                stage = [DeepGBlock(cin, cout if last else cin, cond,
                                    upsample=arch["upsample"][i] and last,
                                    channel_ratio=cfg.channel_ratio, sn_eps=cfg.SN_eps,
                                    bn_eps=cfg.BN_eps, norm_style=cfg.norm_style, **sn)]
                if last and arch["attention"][i]:
                    stage.append(SelfAttention(cout, sn_eps=cfg.SN_eps, **sn))
                blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        c = arch["out_channels"][-1]
        self.output_layer = nn.ModuleList([
            ScaledBatchNorm(c, eps=cfg.BN_eps, device=device),
            nn.ReLU(),
            SNConv(c, 3, 3, eps=cfg.SN_eps, **sn),
        ])
        self.eval()

    def forward(self, z, label=None, feats=None, standing: bool = False):
        cfg = self.cfg
        embs = []
        if cfg.class_cond:
            if label is None:
                raise ValueError("a class-conditional generator needs labels")
            embs.append(self.shared(label))
        elif label is not None:
            raise ValueError("this generator is not class-conditional")
        if cfg.instance_cond:
            if feats is None:
                raise ValueError("an instance-conditioned generator needs feats")
            embs.append(self.shared_feat(feats))
        y = None
        if embs:
            dt = functools.reduce(torch.promote_types, [e.dtype for e in embs])
            y = torch.cat([e.to(dt) for e in embs], dim=1)
        if self.joined:
            # [class, feat, z], read by the stem and by every batch norm (ref :375-379).
            y = torch.cat([y, z.to(y.dtype)], dim=1)
            h = self.linear(y)
        else:
            h = self.linear(z)
        h = h.view(h.shape[0], -1, cfg.bottom_width, cfg.bottom_width)
        for stage in self.blocks:
            h = stage[0](h, y, standing)
            for attn in stage[1:]:
                h = attn(h)
        bn, _, conv = self.output_layer
        h = conv(F.relu(bn(h, standing)))
        return torch.tanh(h.float())


class Discriminator(nn.Module):
    """BigGAN-deep discriminator: the stem ``input_conv``, ``D_depth``
    bottleneck blocks a stage (the first of each downsamples), attention
    after its stage, a global sum pool and the projection heads of the BigGAN
    D (class ``embed``, instance ``linear_feat``, each half the top width
    when both).

    ``forward(x, label=None, feats=None)``: images (N, 3, res, res) → scores
    (N, 1), float32.  Runs on ``device`` (default CUDA); built in eval mode.
    """

    def __init__(self, cfg: BigGANDeepConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        arch = cfg.d_arch
        sn = dict(num_svs=cfg.num_D_SVs, num_itrs=cfg.num_SV_itrs, dtype=cfg.dtype,
                  device=device, generator=generator)
        self.input_conv = SNConv(3, arch["in_channels"][0], 3, eps=cfg.SN_eps, **sn)
        blocks = []
        for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
            stage = [DeepDBlock(cin if d == 0 else cout, cout,
                                downsample=arch["downsample"][i] and d == 0,
                                channel_ratio=cfg.channel_ratio, sn_eps=cfg.SN_eps, **sn)
                     for d in range(cfg.D_depth)]
            if arch["attention"][i]:
                stage.append(SelfAttention(cout, sn_eps=cfg.SN_eps, **sn))
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        top = arch["out_channels"][-1]
        self.linear = SNDense(top, 1, eps=cfg.SN_eps, **sn)
        head = top // 2 if cfg.class_cond and cfg.instance_cond else top
        if cfg.class_cond:
            self.embed = SNEmbed(cfg.n_classes, head, eps=cfg.SN_eps, **sn)
        if cfg.instance_cond:
            self.linear_feat = SNDense(cfg.instance_sz, head, eps=cfg.SN_eps, **sn)
        self.eval()

    def forward(self, x, label=None, feats=None):
        cfg = self.cfg
        if label is not None and not cfg.class_cond:
            raise ValueError("this discriminator is not class-conditional")
        h = self.input_conv(x)
        for stage in self.blocks:
            for m in stage:
                h = m(h)
        h = torch.sum(F.relu(h), dim=(2, 3))
        out = self.linear(h)
        proj = []
        if cfg.class_cond:
            if label is None:
                raise ValueError("a class-conditional discriminator needs labels")
            proj.append(self.embed(label))
        if cfg.instance_cond:
            if feats is None:
                raise ValueError("an instance-conditioned discriminator needs feats")
            proj.append(self.linear_feat(feats.to(cfg.dtype)))
        if proj:
            out = out + torch.sum(torch.cat(proj, dim=1) * h, dim=1, keepdim=True)
        return out.float()


def model_classes(cfg: BigGANConfig):
    """(Generator, Discriminator) classes of the backbone ``cfg`` configures:
    BigGAN-deep's for a ``BigGANDeepConfig``, BigGAN's for a
    ``BigGANConfig``; anything else raises."""
    if isinstance(cfg, BigGANDeepConfig):
        return Generator, Discriminator
    if isinstance(cfg, BigGANConfig):
        from ic_gan_tpu_torch.models import biggan

        return biggan.Generator, biggan.Discriminator
    raise NotImplementedError(
        f"{type(cfg).__name__}: not a BigGAN or BigGAN-deep model config")
