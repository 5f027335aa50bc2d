"""The BigGAN/IC-GAN training step: port of ``ic_gan_tpu/train/step.py``.

Reproduces the reference training dynamics (``train_fns.py:28-193``):

  for D_step in range(num_D_steps):
    for acc in range(num_D_accumulations):
      fresh conditioning -> z; D(fake‖real) -> loss / num_acc -> backward
    Adam(D)
  for acc in range(num_G_accumulations):
    fresh conditioning -> z; G loss / num_acc -> backward
  Adam(G); EMA update (gated on ema_start)

The JAX package scans over microbatches inside one jitted function; here the
loops are plain Python over eager PyTorch, with gradients accumulated in
``.grad``.  G runs in training mode throughout, under ``no_grad`` in the D
phase (its batch-norm statistics and spectral-norm state still advance, as
the reference's ``torch.set_grad_enabled(False)`` around G does); D's
parameters are frozen in the G phase, so only G's gradients are formed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ic_gan_tpu_torch.train import losses as losses_lib
from ic_gan_tpu_torch.train.state import (
    GANTrainState,
    ema_update,
    frozen,
    make_optimizer,
    scrub_grads,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters (reference flag names)."""

    num_D_steps: int = 1
    num_D_accumulations: int = 1
    num_G_accumulations: int = 1
    G_lr: float = 5e-5
    D_lr: float = 2e-4
    G_B1: float = 0.0
    G_B2: float = 0.999
    D_B1: float = 0.0
    D_B2: float = 0.999
    adam_eps: float = 1e-6
    loss: str = "hinge"
    ema: bool = True
    ema_decay: float = 0.9999
    ema_start: int = 20000
    G_ortho: float = 0.0
    D_ortho: float = 0.0
    DiffAugment: str = ""  # e.g. "color,translation,cutout"
    z_var: float = 1.0
    class_cond: bool = False
    instance_cond: bool = True
    # Run D separately on fake and real instead of one concatenated batch
    # (ref BigGAN.py:679-687 via train_fns.py:95).
    split_D: bool = False

    def g_optimizer(self):
        return make_optimizer(self.G_lr, self.G_B1, self.G_B2, self.adam_eps)

    def d_optimizer(self):
        return make_optimizer(self.D_lr, self.D_B1, self.D_B2, self.adam_eps)


@torch.no_grad()
def ortho_grad_term(module: nn.Module, strength: float,
                    blacklist_paths: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Modified orthogonal regularization as a gradient term (ref
    ``BigGAN_PyTorch/utils.py:1073-1099``): s·2·(WWᵀ∘(1−I))W on the
    (out, fan_in) matricization, for every parameter of rank ≥ 2 whose name
    holds none of ``blacklist_paths``.  WWᵀ does not depend on the column
    order, so the term matches the JAX package's on its HWIO layout."""
    terms = {}
    for name, w in module.named_parameters():
        if w.dim() < 2 or any(b in name for b in blacklist_paths):
            continue
        mat = w.reshape(w.shape[0], -1)
        wwt = mat @ mat.T
        wwt = wwt - torch.diag(torch.diag(wwt))
        terms[name] = strength * (2.0 * (wwt @ mat)).reshape(w.shape)
    return terms


def _finish_grads(module: nn.Module, ortho: float, blacklist=()):
    """Zero for a parameter that got no gradient (the JAX step's zero
    cotangent), plus the orthogonal term; then scrubbed.  Returns the
    non-finite count."""
    terms = ortho_grad_term(module, ortho, blacklist) if ortho > 0.0 else {}
    for name, p in module.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        if name in terms:
            p.grad.add_(terms[name])
    return scrub_grads(module.parameters())


def _snapshot_grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def make_train_step(cfg: TrainConfig, dim_z: int, debug_grads: bool = False):
    """The train step ``step(state, batch, generator=None, zs=None) ->
    (state, metrics)``; it updates ``state`` in place.

    ``batch`` holds slabs whose leading axis is the microbatch index:
      x          (nD·accD, mb, 3, H, W)  real images in [-1, 1]
      feats      (nD·accD, mb, F)        real-instance features
      gen_feats  (nD·accD + accG, mb, F) fresh sampled conditioning
    z ~ N(0, z_var) is drawn from ``generator`` (a ``torch.Generator`` on the
    networks' device) once per microbatch, D's first, then G's; ``zs`` may
    give those draws instead, in that order.  Metrics: ``D_loss_real``,
    ``D_loss_fake``, ``G_loss`` and the non-finite gradient counts
    ``D_grad_nonfinite``/``G_grad_nonfinite``, as 0-d tensors on the device;
    with ``debug_grads``, the raw post-ortho, post-scrub gradients
    ``d_grads``/``g_grads`` by parameter name.
    """
    if cfg.DiffAugment:
        raise NotImplementedError(
            "DiffAugment needs data/augment.py, which is not ported yet (ROADMAP.md A.13)")
    if cfg.class_cond:
        raise NotImplementedError(
            "class-conditional training needs SNEmbed, which is not ported yet "
            "(ROADMAP.md A.3)")
    d_loss_fn = losses_lib.D_LOSSES[cfg.loss]
    g_loss_fn = losses_lib.G_LOSSES[cfg.loss]
    n_acc_d, n_acc_g = cfg.num_D_accumulations, cfg.num_G_accumulations
    nD = cfg.num_D_steps * n_acc_d

    def feats_of(batch, key, i):
        return batch[key][i] if cfg.instance_cond else None

    def train_step(state: GANTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   zs: Optional[Sequence[torch.Tensor]] = None):
        g, d = state.g.train(), state.d.train()
        mb = batch["x"].shape[1]
        if zs is None:
            device = batch["x"].device
            zs = [torch.randn((mb, dim_z), generator=generator, device=device)
                  * math.sqrt(cfg.z_var) for _ in range(nD + n_acc_g)]
        elif len(zs) != nD + n_acc_g:
            raise ValueError(f"zs must hold {nD + n_acc_g} draws, got {len(zs)}")
        metrics = {}

        # ---- D phase: num_D_steps optimizer steps, each over
        # num_D_accumulations microbatches. ----
        for d_step in range(cfg.num_D_steps):
            state.d_opt.zero_grad(set_to_none=True)
            loss_real = loss_fake = 0.0
            for acc in range(n_acc_d):
                i = d_step * n_acc_d + acc
                x_real, z = batch["x"][i], zs[i]
                gf, df = feats_of(batch, "gen_feats", i), feats_of(batch, "feats", i)
                with torch.no_grad():
                    fake = g(z, None, gf)
                if cfg.split_D:
                    # The real pass sees the spectral-norm state the fake
                    # pass advanced, as in the reference.
                    d_fake = d(fake, None, gf)
                    d_real = d(x_real, None, df)
                else:
                    fts = None if df is None else torch.cat([gf, df])
                    d_fake, d_real = d(torch.cat([fake, x_real]), None, fts).split(
                        [z.shape[0], x_real.shape[0]])
                lr_, lf_ = d_loss_fn(d_fake, d_real)
                ((lr_ + lf_) / n_acc_d).backward()
                loss_real = loss_real + lr_.detach()
                loss_fake = loss_fake + lf_.detach()
            metrics["D_grad_nonfinite"] = _finish_grads(d, cfg.D_ortho)
            if debug_grads:
                metrics["d_grads"] = _snapshot_grads(d)
            state.d_opt.step()
            metrics["D_loss_real"] = loss_real / n_acc_d
            metrics["D_loss_fake"] = loss_fake / n_acc_d

        # ---- G phase ----
        state.g_opt.zero_grad(set_to_none=True)
        g_loss = 0.0
        with frozen(d):
            for acc in range(n_acc_g):
                gf = feats_of(batch, "gen_feats", nD + acc)
                fake = g(zs[nD + acc], None, gf)
                loss = g_loss_fn(d(fake, None, gf)) / n_acc_g
                loss.backward()
                g_loss = g_loss + loss.detach()
        metrics["G_loss"] = g_loss
        # Blacklist the class embedding (ref train_fns.py:170-175); the
        # match is by substring, as in the JAX package.
        metrics["G_grad_nonfinite"] = _finish_grads(g, cfg.G_ortho, ("shared",))
        if debug_grads:
            metrics["g_grads"] = _snapshot_grads(g)
        state.g_opt.step()

        # ---- EMA (decay gated on ema_start, ref utils.py:1055-1061) ----
        if cfg.ema:
            ema_update(state.g_ema, g,
                       cfg.ema_decay if state.step >= cfg.ema_start else 0.0)
        state.step += 1
        return state, metrics

    return train_step
