"""The GAN train state: both networks, the EMA copy of G, both optimizers
and the step count.  Port of ``ic_gan_tpu/train/state.py``; the networks'
mutable state (spectral-norm ``u0``/``sv0``, batch-norm statistics) lives in
their buffers."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Callable

import torch
import torch.nn as nn


@dataclasses.dataclass
class GANTrainState:
    g: nn.Module
    d: nn.Module
    g_ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, g: nn.Module, d: nn.Module, g_tx: Callable, d_tx: Callable):
        """G and D in training mode, an eval-mode EMA copy of G with buffers
        of its own, and the optimizers ``g_tx(params)`` / ``d_tx(params)``
        (``make_optimizer``)."""
        g_ema = copy.deepcopy(g).eval().requires_grad_(False)
        return cls(g=g.train(), d=d.train(), g_ema=g_ema,
                   g_opt=g_tx(g.parameters()), d_opt=d_tx(d.parameters()))


def make_optimizer(lr: float, b1: float = 0.0, b2: float = 0.999,
                   eps: float = 1e-6) -> Callable:
    """Adam with BigGAN's defaults (G_lr 5e-5 / D_lr 2e-4, β=(0, 0.999), eps
    1e-6), as a factory of parameters.  ``torch.optim.Adam`` steps by
    lr·m̂/(√v̂ + ε), as ``optax.adam`` does."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2), eps=eps)


@torch.no_grad()
def ema_update(ema: nn.Module, live: nn.Module, decay: float) -> None:
    """``ema = decay·ema + (1−decay)·live`` over the parameters and every
    floating buffer (batch-norm statistics and spectral-norm state follow the
    live network, as the reference copies buffers with the same β); with
    ``decay`` 0 the copy is exact."""
    pairs = list(zip(ema.parameters(), live.parameters()))
    pairs += [(e, p) for e, p in zip(ema.buffers(), live.buffers())
              if p.is_floating_point()]
    for e, p in pairs:
        e.copy_(e * decay + p * (1.0 - decay))


@torch.no_grad()
def scrub_grads(params) -> torch.Tensor:
    """Replace NaN/±Inf gradient entries in place (reference
    ``training_loop.py:517-521``: nan 0, ±1e5), so one bad bf16 microbatch
    cannot poison Adam's moments and the EMA.  Returns the count of
    non-finite entries, a float32 scalar on the gradients' device."""
    grads = [p.grad for p in params if p.grad is not None]
    count = sum((~torch.isfinite(g)).sum(dtype=torch.float32) for g in grads)
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=1e5, neginf=-1e5)
    return torch.as_tensor(count, dtype=torch.float32)


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Parameters of ``module`` need no gradient inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags):
            p.requires_grad_(flag)
