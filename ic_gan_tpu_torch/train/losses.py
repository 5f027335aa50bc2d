"""BigGAN losses (reference ``BigGAN_PyTorch/losses.py``), port of the
BigGAN half of ``ic_gan_tpu/train/losses.py``.  The StyleGAN2 losses come
with that model (ROADMAP.md A.13)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_d_loss(d_fake: torch.Tensor, d_real: torch.Tensor):
    loss_real = torch.mean(F.relu(1.0 - d_real))
    loss_fake = torch.mean(F.relu(1.0 + d_fake))
    return loss_real, loss_fake


def hinge_g_loss(d_fake: torch.Tensor):
    return -torch.mean(d_fake)


def dcgan_d_loss(d_fake: torch.Tensor, d_real: torch.Tensor):
    loss_real = torch.mean(F.softplus(-d_real))
    loss_fake = torch.mean(F.softplus(d_fake))
    return loss_real, loss_fake


def dcgan_g_loss(d_fake: torch.Tensor):
    return torch.mean(F.softplus(-d_fake))


D_LOSSES = {"hinge": hinge_d_loss, "dcgan": dcgan_d_loss}
G_LOSSES = {"hinge": hinge_g_loss, "dcgan": dcgan_g_loss}
