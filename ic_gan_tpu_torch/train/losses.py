"""GAN losses, port of ``ic_gan_tpu/train/losses.py``: BigGAN's (reference
``BigGAN_PyTorch/losses.py``) and StyleGAN2's (reference
``stylegan2_ada_pytorch/training/loss.py``)."""

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


# --- StyleGAN2: non-saturating logistic losses and the regularizers (reference
#     training/loss.py:85-194), as the StyleGAN2 step uses them ---------------------


def logistic_d_loss(d_fake: torch.Tensor, d_real: torch.Tensor):
    loss_real = torch.mean(F.softplus(-d_real))
    loss_fake = torch.mean(F.softplus(d_fake))
    return loss_real, loss_fake


def logistic_g_loss(d_fake: torch.Tensor):
    return torch.mean(F.softplus(-d_fake))


def r1_penalty(real_logits: torch.Tensor, x_real: torch.Tensor) -> torch.Tensor:
    """Per-sample |∇ₓ D(x)|² on the reals (ref loss.py:177-194).  The
    gradient keeps its graph, so the penalty differentiates again."""
    (grads,) = torch.autograd.grad(real_logits.sum(), x_real, create_graph=True)
    return grads.square().sum(dim=(1, 2, 3))


def path_lengths(img: torch.Tensor, ws: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-sample |J_wᵀ y| for y = ``noise`` (ref loss.py:111-140): the
    root of the mean over the ws of the squared gradient norm, with its
    graph kept for the penalty's gradient."""
    (grads,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
    return grads.square().sum(dim=2).mean(dim=1).sqrt()
