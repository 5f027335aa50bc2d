"""IC-GAN BigGAN generator and discriminator in PyTorch (NCHW).

Port of ``ic_gan_tpu/models/biggan.py`` (``g_arch``, ``d_arch``,
``BigGANConfig``, ``Generator``, ``Discriminator``).  Module names follow the
upstream torch tree, so ``state_dict()`` keys are the reference's.  G:
``shared`` (the class table), ``shared_feat``, ``linear``, ``blocks.{i}.0``
(GBlock), ``blocks.{i}.1`` (attention), ``output_layer.0`` (batch norm) and
``output_layer.2`` (conv).  D: ``blocks.{i}.0`` (DBlock), ``blocks.{i}.1``
(attention), ``linear``, and the projection heads ``embed`` (classes) and
``linear_feat`` (instances).  ``module.train()`` is the JAX package's
``train=True``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.icgan_ref import resolve_device
from reference.icgan_ref.models.layers import (
    BN_EPS,
    SN_EPS,
    DBlock,
    GBlock,
    ScaledBatchNorm,
    SelfAttention,
    SNConv,
    SNDense,
    SNEmbed,
    _ortho,
)


def _attn_set(attention: str):
    return [int(item) for item in str(attention).split("_") if item not in ("", "0")]


def g_arch(resolution: int, ch: int, attention: str = "64") -> Dict[str, Any]:
    """Generator channel table (ref ``BigGAN.py:32-85``)."""
    tables = {
        512: ([16, 16, 8, 8, 4, 2, 1], [16, 8, 8, 4, 2, 1, 1]),
        256: ([16, 16, 8, 8, 4, 2], [16, 8, 8, 4, 2, 1]),
        128: ([16, 16, 8, 4, 2], [16, 8, 4, 2, 1]),
        64: ([16, 16, 8, 4], [16, 8, 4, 2]),
        32: ([4, 4, 4], [4, 4, 4]),
    }
    cin, cout = tables[resolution]
    n = len(cin)
    res = [2 ** (i + 3) for i in range(n)]
    attn = set(_attn_set(attention))
    return {
        "in_channels": [ch * c for c in cin],
        "out_channels": [ch * c for c in cout],
        "upsample": [True] * n,
        "resolution": res,
        "attention": [r in attn for r in res],
    }


def d_arch(resolution: int, ch: int, attention: str = "64") -> Dict[str, Any]:
    """Discriminator channel table (ref ``BigGAN.py:390-432``)."""
    tables = {
        256: ([1, 2, 4, 8, 8, 16], [1, 2, 4, 8, 8, 16, 16], 6, [128, 64, 32, 16, 8, 4, 4]),
        128: ([1, 2, 4, 8, 16], [1, 2, 4, 8, 16, 16], 5, [64, 32, 16, 8, 4, 4]),
        64: ([1, 2, 4, 8], [1, 2, 4, 8, 16], 4, [32, 16, 8, 4, 4]),
    }
    if resolution == 32:
        cin = [3] + [4 * ch] * 3
        cout = [4 * ch] * 4
        down = [True, True, False, False]
        res = [16, 16, 16, 16]
    else:
        mults_in, mults_out, n_down, res = tables[resolution]
        cin = [3] + [ch * m for m in mults_in]
        cout = [ch * m for m in mults_out]
        down = [True] * n_down + [False] * (len(cout) - n_down)
    attn = set(_attn_set(attention))
    return {
        "in_channels": cin,
        "out_channels": cout,
        "downsample": down,
        "resolution": res,
        "attention": [r in attn for r in res],
    }


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    """Generator hyperparameters; names track the JAX config and the
    reference flags.  ``dtype`` is the compute type."""

    resolution: int = 64
    n_classes: int = 1000
    G_ch: int = 64
    D_ch: int = 64
    dim_z: int = 120
    bottom_width: int = 4
    G_attn: str = "64"
    D_attn: str = "64"
    G_shared: bool = True
    shared_dim: int = 128
    hier: bool = True
    class_cond: bool = False
    instance_cond: bool = True
    G_shared_feat: bool = True
    shared_dim_feat: int = 512
    instance_sz: int = 2048
    D_wide: bool = True
    num_G_SVs: int = 1
    num_D_SVs: int = 1
    num_SV_itrs: int = 1
    SN_eps: float = SN_EPS
    BN_eps: float = BN_EPS
    norm_style: str = "bn"
    dtype: torch.dtype = torch.float32

    @property
    def g_arch(self):
        return g_arch(self.resolution, self.G_ch, self.G_attn)

    @property
    def d_arch(self):
        return d_arch(self.resolution, self.D_ch, self.D_attn)

    @property
    def num_slots(self) -> int:
        return len(self.g_arch["in_channels"]) + 1 if self.hier else 1

    @property
    def z_chunk_size(self) -> int:
        return self.dim_z // self.num_slots if self.hier else 0

    @property
    def effective_dim_z(self) -> int:
        """z width the model reads: at 256², dim_z 120 gives 7 chunks of 17,
        so 119."""
        return self.z_chunk_size * self.num_slots if self.hier else self.dim_z

    @property
    def shared_dim_eff(self) -> int:
        return self.shared_dim if self.shared_dim > 0 else self.dim_z

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class Generator(nn.Module):
    """IC-GAN BigGAN generator.

    ``forward(z, label=None, feats=None, standing=False)``: z (N, dim_z),
    label (N,) integer classes when ``class_cond``, feats (N, instance_sz)
    instance features when ``instance_cond`` → images (N, 3, res, res),
    float32 in [-1, 1].  ``standing=True`` accumulates standing batch-norm statistics.
    Runs on ``device`` (default CUDA); weights are drawn from ``generator``
    (a ``torch.Generator`` on that device) or the default one.  Built in eval
    mode; in training mode batch norm takes the batch's moments and every
    spectrally normalized layer advances its state.  Build with
    ``torch.nn.utils.skip_init(Generator, cfg, device=...)`` to skip the
    initializers before ``load_state_dict``.
    """

    def __init__(self, cfg: BigGANConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        arch = cfg.g_arch
        sn = dict(num_svs=cfg.num_G_SVs, num_itrs=cfg.num_SV_itrs, dtype=cfg.dtype,
                  device=device, generator=generator)
        cond = 0
        if cfg.class_cond:
            # An unnormalized table (ref BigGAN.py:202-204), read in float32.
            width = cfg.shared_dim_eff if cfg.G_shared else cfg.n_classes
            self.shared = nn.Embedding(cfg.n_classes, width, device=device,
                                       _weight=_ortho((cfg.n_classes, width), device, generator))
            cond = width
        if cfg.instance_cond:
            if cfg.G_shared_feat:
                self.shared_feat = SNDense(cfg.instance_sz, cfg.shared_dim_feat,
                                           eps=cfg.SN_eps, **sn)
                cond += cfg.shared_dim_feat
            else:
                cond += cfg.instance_sz
        cond += cfg.z_chunk_size
        z0 = cfg.z_chunk_size if cfg.hier else cfg.dim_z
        self.linear = SNDense(z0, arch["in_channels"][0] * cfg.bottom_width ** 2,
                              eps=cfg.SN_eps, **sn)
        blocks = []
        for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
            stage = [GBlock(cin, cout, cond, upsample=arch["upsample"][i],
                            sn_eps=cfg.SN_eps, bn_eps=cfg.BN_eps,
                            norm_style=cfg.norm_style, **sn)]
            if arch["attention"][i]:
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
            embs.append(self.shared_feat(feats) if cfg.G_shared_feat else feats.to(cfg.dtype))
        # [class, feat], in the wider of their types (JAX's concatenate).
        y = None
        if embs:
            dt = functools.reduce(torch.promote_types, [e.dtype for e in embs])
            y = torch.cat([e.to(dt) for e in embs], dim=1)
        if cfg.hier:
            # The first chunk feeds the stem; each later one joins the
            # conditioning of one block's batch norms.
            c = cfg.z_chunk_size
            zs = [z[:, i * c:(i + 1) * c] for i in range(cfg.num_slots)]
            z0 = zs[0]
            ys = [zi if y is None else torch.cat([y, zi.to(y.dtype)], dim=1)
                  for zi in zs[1:]]
        else:
            z0, ys = z, [y] * len(self.blocks)
        h = self.linear(z0)
        h = h.view(h.shape[0], -1, cfg.bottom_width, cfg.bottom_width)
        for stage, yi in zip(self.blocks, ys):
            h = stage[0](h, yi, standing)
            for attn in stage[1:]:
                h = attn(h)
        bn, _, conv = self.output_layer
        h = conv(F.relu(bn(h, standing)))
        return torch.tanh(h.float())


class Discriminator(nn.Module):
    """IC-GAN BigGAN discriminator with the class and instance projection
    heads (ref ``BigGAN.py:548-563, 629-641``): class only, ``embed`` of
    the top width; instance only, ``linear_feat`` of that width; both, each
    of half of it, concatenated [class, instance].

    ``forward(x, label=None, feats=None)``: images x (N, 3, res, res), label
    (N,), feats (N, instance_sz) → scores (N, 1), float32.  The compute type is
    ``cfg.dtype``; weights and state are float32.  Runs on ``device``
    (default CUDA), weights drawn from ``generator``.  Built in eval mode.
    """

    def __init__(self, cfg: BigGANConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        arch = cfg.d_arch
        sn = dict(num_svs=cfg.num_D_SVs, num_itrs=cfg.num_SV_itrs, dtype=cfg.dtype,
                  device=device, generator=generator)
        blocks = []
        for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
            stage = [DBlock(cin, cout, wide=cfg.D_wide, preactivation=i > 0,
                            downsample=arch["downsample"][i], sn_eps=cfg.SN_eps, **sn)]
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
        h = x.to(cfg.dtype)
        for stage in self.blocks:
            for m in stage:
                h = m(h)
        # Global sum pool over space (ref BigGAN.py:625).
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
