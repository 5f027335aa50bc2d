"""Project a target image into StyleGAN2's W space: port of
``ic_gan_tpu/cli/projector.py``.

Reference: ``stylegan2_ada_pytorch/projector.py:36-66``: optimize one w to
reconstruct a target under a perceptual loss, with w initialized at w_avg,
ramped-down noise on w and a cosine-ramped learning rate.

The perceptual features are LPIPS-VGG16's (``eval/metrics.py:
make_lpips_feature_fn``) when a weight file is given
(``$ICGAN_VGG16_WEIGHTS``), else InceptionV3's pool features
(``eval/pipeline.py:InceptionEvaluator``), as in the JAX package; a
``feature_fn`` of the caller's replaces both.  Each step backpropagates
through the synthesis network (the bias-activation kernel's forward and
backward on the card) to w alone.

What the JAX package does is kept, not what its docstring says: only w is
optimized, the synthesis runs with ``noise_mode="const"``, and
``regularize_noise_weight`` is accepted and unused; the learning-rate ramp
scales the gradient handed to Adam, not Adam's step size, so the first step
(ramp 0) moves nothing (``ROADMAP.md`` §C).  The draws (w_avg's z, the noise
on w) come from a ``torch.Generator`` seeded ``seed`` on the model's device.

    python -m ic_gan_tpu_torch.cli.projector --set network_pkl=net.pkl \\
        target=img.png out_dir=proj/ num_steps=1000 [--device cuda]
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def schedule(it: int, num_steps: int, initial_noise_factor: float = 0.05,
             lr_rampdown_length: float = 0.25, lr_rampup_length: float = 0.05,
             noise_ramp_length: float = 0.75):
    """(lr ramp, noise factor) of step ``it`` (ref ``projector.py:98-106``):
    the w noise is w_std times the factor."""
    t = it / num_steps
    noise = initial_noise_factor * max(0.0, 1.0 - t / noise_ramp_length) ** 2
    lr_ramp = min(1.0, (1.0 - t) / lr_rampdown_length)
    lr_ramp = 0.5 - 0.5 * np.cos(lr_ramp * np.pi)
    return lr_ramp * min(1.0, t / lr_rampup_length), noise


def default_feature_fn(device) -> Callable:
    """NCHW images in [-1, 1] → perceptual features, differentiable in the
    images: LPIPS-VGG16 with ``$ICGAN_VGG16_WEIGHTS``, else InceptionV3's
    pool features."""
    if os.environ.get("ICGAN_VGG16_WEIGHTS"):
        from ic_gan_tpu_torch.eval.metrics import make_lpips_feature_fn

        return make_lpips_feature_fn(device=device)
    from ic_gan_tpu_torch.eval.pipeline import InceptionEvaluator

    net = InceptionEvaluator(device=device).net
    return lambda imgs: net(imgs)[0]


def project(
    g,
    target,
    *,
    cond_feats=None,
    cond_label=None,
    num_steps: int = 1000,
    w_avg_samples: int = 10000,
    initial_learning_rate: float = 0.1,
    initial_noise_factor: float = 0.05,
    lr_rampdown_length: float = 0.25,
    lr_rampup_length: float = 0.05,
    noise_ramp_length: float = 0.75,
    regularize_noise_weight: float = 1e5,
    feature_fn: Optional[Callable] = None,
    seed: int = 0,
    verbose: bool = False,
):
    """Project ``target`` ((H, W, 3) in [-1, 1]) into the W space of the
    StyleGAN2 generator ``g``, on ``g``'s device.  ``feature_fn``: NCHW
    images in [-1, 1] → features, differentiable.  Returns ``(w
    (num_ws, w_dim), history of the losses)``.

    Schedule and loss mirror the reference (``projector.py:36-140``): w
    starts at w_avg with σ_w from ``w_avg_samples`` mappings; the noise on w
    ramps down; the loss is the squared distance of the features."""
    device = next(g.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    z = _randn((w_avg_samples, g.cfg.z_dim), gen, device)
    c = h = None
    if cond_feats is not None:
        h = torch.as_tensor(cond_feats, device=device)[None].expand(w_avg_samples, -1)
    if cond_label is not None:
        c = torch.as_tensor(cond_label, device=device)[None].expand(w_avg_samples, -1)
    with torch.no_grad():
        ws = g.map_ws(z, c, h)
        w_avg = ws[:, :1].mean(dim=0, keepdim=True)                    # (1, 1, w_dim)
        w_std = float(torch.sqrt((ws[:, :1] - w_avg).square().mean()))
    num_ws = ws.shape[1]
    del ws, z

    if feature_fn is None:
        feature_fn = default_feature_fn(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    with torch.no_grad():
        target_feats = feature_fn(target.permute(2, 0, 1)[None])

    w_opt = w_avg[:, 0].clone().requires_grad_(True)                    # (1, w_dim)
    opt = torch.optim.Adam([w_opt], lr=initial_learning_rate, betas=(0.9, 0.999))
    history = []
    for it in range(num_steps):
        lr_ramp, noise_factor = schedule(it, num_steps, initial_noise_factor,
                                         lr_rampdown_length, lr_rampup_length,
                                         noise_ramp_length)
        w_noisy = w_opt + _randn(w_opt.shape, gen, device) * (w_std * noise_factor)
        img = g.synthesize(w_noisy[:, None].expand(1, num_ws, -1), noise_mode="const")
        loss = (feature_fn(img) - target_feats).square().sum()
        (grad,) = torch.autograd.grad(loss, [w_opt])
        w_opt.grad = grad * lr_ramp
        opt.step()
        history.append(loss.item())
        if verbose and it % 100 == 0:
            print(f"step {it}: loss {history[-1]:.4f}")
    return w_opt.detach().expand(num_ws, -1), history


def main(argv=None):
    """Projection CLI (reference ``projector.py:147-186``): load a StyleGAN2
    network, centre-crop and resize the target, optimize w, and write
    ``target.png``, ``proj.png`` and ``projected_w.npz`` into ``out_dir``.
    Runs on CUDA unless ``--device`` names another device."""
    from PIL import Image

    from ic_gan_tpu_torch.cli.config import parse_args
    from ic_gan_tpu_torch.cli.inference import (
        device_flag,
        load_generator,
        load_stored_features,
        save_image_grid,
    )

    cfg = parse_args(argv)
    cfg.setdefault("backbone", "stylegan2")
    g, model_cfg = load_generator(cfg, device_flag(argv))
    res = model_cfg.img_resolution

    # Centre square crop and LANCZOS resize (ref projector.py:150-155).
    img = Image.open(cfg["target"]).convert("RGB")
    s = min(img.size)
    left, top = (img.size[0] - s) // 2, (img.size[1] - s) // 2
    img = img.crop((left, top, left + s, top + s)).resize((res, res), Image.LANCZOS)
    target = np.asarray(img, np.float32) / 127.5 - 1.0

    cond_feats = None
    if cfg.get("stored_features") and getattr(model_cfg, "h_dim", 0):
        feats, _ = load_stored_features(cfg["stored_features"])
        cond_feats = feats[cfg.get("input_feature_index", 0)]

    w_opt, history = project(
        g, target, cond_feats=cond_feats, num_steps=cfg.get("num_steps", 1000),
        w_avg_samples=cfg.get("w_avg_samples", 10000), seed=cfg.get("seed", 0), verbose=True)

    out_dir = cfg.get("out_dir", "proj")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "projected_w.npz"), w=w_opt.cpu().numpy()[None])
    with torch.no_grad():
        final = g.synthesize(w_opt[None], noise_mode="const").permute(0, 2, 3, 1)
    save_image_grid(target[None], os.path.join(out_dir, "target.png"), nrow=1)
    save_image_grid(final.float().cpu().numpy(), os.path.join(out_dir, "proj.png"), nrow=1)
    print(f"projected in {len(history)} steps, final loss {history[-1]:.4f}; "
          f"outputs in {out_dir}")
    return history


if __name__ == "__main__":
    main()
