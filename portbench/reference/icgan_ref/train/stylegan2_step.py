"""The StyleGAN2-ADA training step: port of ``ic_gan_tpu/train/stylegan2_step.py``.

Non-saturating logistic loss, lazy R1 and path-length regularization, the ADA
sign statistic, and an EMA of G with ramp-up (reference ``training/loss.py:
31-194``, ``training_loop.py:319-345, 489-551``).  One step runs a G phase
(Gmain, plus Gpl when ``do_pl``) and then a D phase (Dmain, plus Dr1 when
``do_r1``), each one backward and one Adam update; the training loop picks
the variant by ``step % interval``, as the JAX trainer does.

Differences of form from the JAX step, none of them in what is computed:
- the step is eager PyTorch and updates ``state`` in place;
- R1 takes its gradient from the same forward of D on the reals that gives
  the real logits (upstream's ``Dboth`` phase); JAX runs D on the reals a
  second time with the same augmentation draws, which computes the same;
- the random draws come from a ``torch.Generator``; ``draws`` may give the
  step's own (z, z_d, the style-mixing cutoffs and second latents, the PL
  noise) instead, so that a test can replay the JAX draws.

Single process: the path the benchmark's cells drive.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from reference.icgan_ref.train import losses
from reference.icgan_ref.train.state import ema_update, frozen, make_optimizer, scrub_grads


@dataclasses.dataclass(frozen=True)
class SG2TrainConfig:
    """The reference flag surface (``train.py:220-365``)."""

    glr: float = 0.002
    dlr: float = 0.002
    beta2: float = 0.99
    adam_eps: float = 1e-8
    r1_gamma: float = 10.0
    style_mixing_prob: float = 0.9
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    pl_weight: float = 2.0
    G_reg_interval: int = 4
    D_reg_interval: int = 16
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = 0.05
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0
    augment_p: float = 0.0
    freeze_d_layers: int = 0  # Freeze-D: the first N layers of D, highest resolution first

    def _lazy(self, lr: float, interval: int):
        """Lazy-regularization scaling of lr and β (ref training_loop.py:332-340)."""
        ratio = interval / (interval + 1)
        return lr * ratio, 0.0, self.beta2 ** ratio

    def g_optimizer(self):
        lr, b1, b2 = self._lazy(self.glr, self.G_reg_interval)
        return make_optimizer(lr, b1, b2, self.adam_eps)

    def d_optimizer(self):
        lr, b1, b2 = self._lazy(self.dlr, self.D_reg_interval)
        return make_optimizer(lr, b1, b2, self.adam_eps)


@dataclasses.dataclass
class SG2TrainState:
    """Both networks, G's EMA copy, both optimizers, the step and image
    counts, and the scalar state (0-d tensors on the networks' device): the
    path-length mean, ADA's p and its sign statistic."""

    g: nn.Module
    d: nn.Module
    g_ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    pl_mean: torch.Tensor
    ada_p: torch.Tensor
    ada_sign_sum: torch.Tensor
    ada_count: torch.Tensor
    step: int = 0
    cur_nimg: int = 0

    @classmethod
    def create(cls, g: nn.Module, d: nn.Module, cfg: SG2TrainConfig):
        device = next(g.parameters()).device
        zero = lambda: torch.zeros((), device=device)  # noqa: E731
        return cls(g=g.train(), d=d.train(),
                   g_ema=copy.deepcopy(g).eval().requires_grad_(False),
                   g_opt=cfg.g_optimizer()(g.parameters()),
                   d_opt=cfg.d_optimizer()(d.parameters()),
                   pl_mean=zero(), ada_p=torch.tensor(float(cfg.augment_p), device=device),
                   ada_sign_sum=zero(), ada_count=zero())


def freeze_d_mask(d: nn.Module, freeze_layers: int) -> Dict[str, bool]:
    """Freeze-D: parameter name → trainable.  Layers count per resolution
    block, highest first, in the order fromrgb, conv0, conv1, skip (ref
    ``networks.py:819-830``); the 4×4 epilogue always trains."""
    frozen_layers = set()
    idx = 0
    for res in d.block_resolutions:
        block = getattr(d, f"b{res}")
        for layer in ("fromrgb", "conv0", "conv1", "skip"):
            if hasattr(block, layer):
                if idx < freeze_layers:
                    frozen_layers.add(f"b{res}.{layer}.")
                idx += 1
    return {name: not any(name.startswith(f) for f in frozen_layers)
            for name, _ in d.named_parameters()}


def _snapshot_grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _fill_missing_grads(module: nn.Module):
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_sg2_train_step(cfg: SG2TrainConfig, z_dim: int, do_pl: bool, do_r1: bool,
                        augment_fn: Optional[Callable] = None, debug_grads: bool = False):
    """The step ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``; it updates ``state`` in place.

    ``batch``: ``x`` (N, C, H, W) reals, optional ``c``/``gen_c`` labels and
    ``h``/``gen_h`` instance features.  ``augment_fn(images, p, generator)``
    is the ADA pipe (None: no augmentation).  ``draws`` may give ``z`` and
    ``z_d`` (N, z_dim), ``cutoffs`` (2,) (the style-mixing cutoff of the G
    phase, then of the D phase; ``num_ws`` means no mixing), ``z2s`` (2, N,
    z_dim) and ``pl_noise`` (N // pl_batch_shrink, C, H, W), unscaled;
    without it they come from ``generator``, in that order.  Metrics, as
    0-d tensors: ``G_loss``, ``fake_scores``, ``D_loss``, ``real_scores``,
    ``real_signs``, the non-finite gradient counts, and ``pl_penalty`` /
    ``r1_penalty`` in the phases that run them; with ``debug_grads`` the
    scrubbed raw gradients ``g_grads``/``d_grads`` by parameter name.
    """
    def draw(g, n, device, generator):
        num_ws, res = g.mapping.num_ws, g.cfg.img_resolution
        randn = lambda *s: torch.randn(s, generator=generator, device=device)  # noqa: E731
        out = dict(z=randn(n, z_dim), z_d=randn(n, z_dim))
        cut = torch.randint(1, num_ws, (2,), generator=generator, device=device)
        mix = torch.rand((2,), generator=generator, device=device) < cfg.style_mixing_prob
        out["cutoffs"] = torch.where(mix, cut, num_ws)
        out["z2s"] = randn(2, n, z_dim)
        if do_pl:
            out["pl_noise"] = randn(max(n // cfg.pl_batch_shrink, 1), g.cfg.img_channels,
                                    res, res)
        return out

    def run_G(g, z, c, h, cutoff, z2, update_w_avg, generator):
        """Mapping, style mixing and synthesis (ref loss.py:58-76)."""
        ws = g.map_ws(z, c, h, update_w_avg=update_w_avg)
        if cfg.style_mixing_prob > 0:
            idx = torch.arange(ws.shape[1], device=ws.device)[None, :, None]
            ws = torch.where(idx < cutoff, ws, g.map_ws(z2, c, h))
        return g.synthesize(ws, generator=generator)

    def run_D(d, img, c, h, p, generator):
        if augment_fn is not None:
            img = augment_fn(img, p, generator)
        return d(img, c, h)

    def train_step(state: SG2TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
        g, d = state.g.train(), state.d.train()
        c, h = batch.get("c"), batch.get("h")
        gen_c, gen_h = batch.get("gen_c", c), batch.get("gen_h", h)
        x_real = batch["x"]
        n = x_real.shape[0]
        if draws is None:
            draws = draw(g, n, x_real.device, generator)
        metrics = {}

        # ---- G phase: Gmain (+ Gpl) ----
        state.g_opt.zero_grad(set_to_none=True)
        with frozen(d):
            img = run_G(g, draws["z"], gen_c, gen_h, draws["cutoffs"][0], draws["z2s"][0],
                        True, generator)
            logits = run_D(d, img, gen_c, gen_h, state.ada_p, generator)
            loss = losses.logistic_g_loss(logits)
            metrics["G_loss"] = loss.detach()
            metrics["fake_scores"] = logits.detach().mean()
            total = loss
            new_pl_mean = state.pl_mean
            if do_pl and cfg.pl_weight != 0:
                nb = max(n // cfg.pl_batch_shrink, 1)
                z_pl, c_pl, h_pl = (None if t is None else t[:nb]
                                    for t in (draws["z"], gen_c, gen_h))
                ws_pl = g.map_ws(z_pl, c_pl, h_pl)
                img_pl = g.synthesize(ws_pl, generator=generator)
                noise = draws["pl_noise"] / math.sqrt(img_pl.shape[2] * img_pl.shape[3])
                pl_len = losses.path_lengths(img_pl, ws_pl, noise.to(img_pl.dtype))
                # The penalty differentiates through the updated mean too, as
                # upstream's lerp does.
                new_pl_mean = state.pl_mean + cfg.pl_decay * (pl_len.mean() - state.pl_mean)
                pl_penalty = (pl_len - new_pl_mean).square().mean()
                metrics["pl_penalty"] = pl_penalty.detach()
                total = total + pl_penalty * cfg.pl_weight * cfg.G_reg_interval
            total.backward()
        _fill_missing_grads(g)
        metrics["G_grad_nonfinite"] = scrub_grads(g.parameters())
        if debug_grads:
            metrics["g_grads"] = _snapshot_grads(g)
        state.g_opt.step()
        state.pl_mean = new_pl_mean.detach()

        # ---- D phase: Dmain (+ Dr1) ----
        state.d_opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            img_fake = run_G(g, draws["z_d"], gen_c, gen_h, draws["cutoffs"][1],
                             draws["z2s"][1], False, generator)
        fake_logits = run_D(d, img_fake, gen_c, gen_h, state.ada_p, generator)
        x_in = x_real.detach().requires_grad_(do_r1 and cfg.r1_gamma != 0)
        real_logits = run_D(d, x_in, c, h, state.ada_p, generator)
        loss_real, loss_fake = losses.logistic_d_loss(fake_logits, real_logits)
        total = loss_fake + loss_real
        metrics["D_loss"] = total.detach()
        metrics["real_scores"] = real_logits.detach().mean()
        metrics["real_signs"] = torch.sign(real_logits.detach()).mean()
        if x_in.requires_grad:
            r1 = losses.r1_penalty(real_logits, x_in).mean()
            metrics["r1_penalty"] = r1.detach()
            total = total + r1 * (cfg.r1_gamma / 2.0) * cfg.D_reg_interval
        # Only D's parameters: the reals' own gradient is not needed.
        total.backward(inputs=[p for p in d.parameters() if p.requires_grad])
        _fill_missing_grads(d)
        if cfg.freeze_d_layers > 0:
            mask = freeze_d_mask(d, cfg.freeze_d_layers)
            for name, p in d.named_parameters():
                if not mask[name]:
                    p.grad.zero_()
        metrics["D_grad_nonfinite"] = scrub_grads(d.parameters())
        if debug_grads:
            metrics["d_grads"] = _snapshot_grads(d)
        state.d_opt.step()

        # ---- EMA with ramp-up (ref training_loop.py:527-535) ----
        state.cur_nimg += n
        ema_nimg = cfg.ema_kimg * 1000.0
        if cfg.ema_rampup is not None:
            ema_nimg = min(ema_nimg, state.cur_nimg * cfg.ema_rampup)
        ema_update(state.g_ema, g, 0.5 ** (n / max(ema_nimg, 1e-8)))

        # ---- ADA sign statistic; ``ada_update`` moves p every ada_interval steps ----
        state.ada_sign_sum = state.ada_sign_sum + metrics["real_signs"] * n
        state.ada_count = state.ada_count + n
        state.step += 1
        return state, metrics

    return train_step


@torch.no_grad()
def ada_update(state: SG2TrainState, cfg: SG2TrainConfig, batch_size: int) -> SG2TrainState:
    """ADA's p-controller (ref training_loop.py:542-551): nudge p so that
    E[sign(D(real))] stays at ``ada_target``; p is clamped below at 0 only,
    as upstream.  Call every ``ada_interval`` steps."""
    mean_sign = state.ada_sign_sum / torch.clamp_min(state.ada_count, 1.0)
    adjust = torch.sign(mean_sign - cfg.ada_target) * (batch_size * cfg.ada_interval) \
        / (cfg.ada_kimg * 1000.0)
    state.ada_p = torch.clamp_min(state.ada_p + adjust, 0.0)
    state.ada_sign_sum = torch.zeros_like(state.ada_sign_sum)
    state.ada_count = torch.zeros_like(state.ada_count)
    return state
