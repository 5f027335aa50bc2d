"""Deployment-mode weight preparation and the fixed-batch sampler.

Port of ``ic_gan_tpu/io/deploy.py``.  ``fold_spectral_norm`` divides every
spectrally normalized weight by its eval-mode σ once, so a forward runs no
power iteration.  ``cast_params`` stores the weights in bfloat16, keeping the
batch-norm statistics (buffers) in float32.  ``make_sampler`` runs a folded
generator over requests of any size in fixed batches, padding the tail.
``accumulate_standing_stats`` drives BigGAN's standing-statistics eval mode.
All of them change the module in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.models.layers import _SpectralNormed


def fold_spectral_norm(module: nn.Module) -> nn.Module:
    """Bake σ into every spectrally normalized weight of ``module`` and drop
    the ``u0``/``sv0`` buffers; the layers then skip the power iteration.
    A folded module loads a folded ``state_dict``."""
    for m in module.modules():
        if isinstance(m, _SpectralNormed):
            m.fold_()
    return module


def cast_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast the floating-point parameters to ``dtype``.  Buffers (batch-norm
    statistics, which parameterize a rsqrt) stay float32."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


def reset_standing_stats(module: nn.Module) -> nn.Module:
    """Zero every batch norm's (stored_mean, stored_var, accum_counter) so a
    fresh standing-statistics accumulation can begin.  Only the ``bn`` style
    keeps a counter; an ``in`` style keeps its running statistics, as the
    JAX package's reset leaves them."""
    with torch.no_grad():
        for m in module.modules():
            if "accum_counter" in m._buffers:
                m.stored_mean.zero_()
                m.stored_var.zero_()
                m.accum_counter.zero_()
    return module


def accumulate_standing_stats(
    g: nn.Module,
    generator: torch.Generator,
    sample_conditioning: Optional[Callable[[int], tuple]] = None,
    *,
    batch_size: int = 32,
    n_accumulations: int = 16,
) -> nn.Module:
    """Reset the statistics, then run ``n_accumulations`` standing-mode
    forwards with fresh z ~ N(0, 1) from ``generator`` (on g's device) and
    fresh conditioning ``sample_conditioning(n) -> (label, feats)``; eval
    then normalizes with the averaged moments (ref ``utils.py:1679-1695``)."""
    reset_standing_stats(g)
    device = next(g.parameters()).device
    with torch.inference_mode():
        for _ in range(n_accumulations):
            z = torch.randn((batch_size, g.cfg.effective_dim_z), device=device,
                            generator=generator)
            label = feats = None
            if sample_conditioning is not None:
                label, feats = sample_conditioning(batch_size)
                label = None if label is None else torch.as_tensor(label, device=device)
                feats = None if feats is None else torch.as_tensor(feats, device=device)
            g(z, label, feats, standing=True)
    return g


def make_sampler(g: nn.Module, *, batch_size: Optional[int] = None, device=None,
                 **apply_kwargs):
    """``sampler(z, label=None, feats=None, device_output=False)`` running
    ``g(z, label, feats, **apply_kwargs)`` (g moved to ``device``, default
    CUDA) in batches of ``batch_size``: the StyleGAN2 generator takes
    ``truncation_psi`` and ``noise_mode`` so.

    Folds spectral norm in place first, so no forward runs a power
    iteration (a StyleGAN2 generator has none, and is left as it is); cast
    the weights beforehand with ``cast_params`` to sample in bf16.  A
    request of any size runs in full batches, the tail padded with copies of
    its first row, so every launch sees one shape.  Returns NHWC
    images, float32: a numpy array, or with ``device_output`` a tensor left
    on the device for a consumer there.
    """
    device = resolve_device(device)
    fold_spectral_norm(g.to(device).eval())

    def sampler(z, label=None, feats=None, device_output: bool = False):
        n = z.shape[0]
        bs = batch_size or n
        outs = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                hi = min(lo + bs, n)
                pad = bs - (hi - lo)
                img = g(*(padded_rows(a, lo, hi, pad, device) for a in (z, label, feats)),
                        **apply_kwargs)
                outs.append(img[: hi - lo].permute(0, 2, 3, 1))
            out = torch.cat(outs) if len(outs) > 1 else outs[0].contiguous()
        return out if device_output else np.ascontiguousarray(out.cpu().numpy())

    # What ``eval.pipeline.make_fused_feature_fn`` runs G with.
    sampler.module, sampler.batch_size, sampler.apply_kwargs = g, batch_size, apply_kwargs
    return sampler


def padded_rows(a, lo: int, hi: int, pad: int, device):
    """Rows ``lo:hi`` of ``a`` (a tensor, an array or None) on ``device``,
    followed by ``pad`` copies of the first, so that a tail batch has the
    full batch's shape."""
    if a is None:
        return None
    a = torch.as_tensor(a[lo:hi], device=device)
    return torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) if pad else a
