"""DiffAugment, differentiable augmentation for GAN training: port of
``ic_gan_tpu/data/augment.py`` (reference ``BigGAN_PyTorch/
diffaugment_utils.py``, Zhao et al. 2020).

Policies ``color`` (brightness, saturation, contrast), ``translation`` and
``cutout`` on an NCHW batch, differentiable in ``x``.  The JAX package's
formulation is kept: translation zero-pads one pixel and gathers with
clipped indices, cutout multiplies by a computed mask whose centre ranges
over ``H + (1 - ch % 2)``.

Each function takes its random draw explicitly (``augment_draws`` makes
them from a ``torch.Generator``): a uniform (N,) in ``x``'s type for the
colour functions, a pair of integer (N,) tensors for translation (the
shifts along H and W) and cutout (the centres).  ``diff_augment`` takes one
draw per function applied, in policy order, so a caller can replay another
implementation's draws.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ic_gan_tpu_torch.parallel import collectives


def rand_brightness(x, u):
    return x + (u.to(x.device, x.dtype) - 0.5).view(-1, 1, 1, 1)


def rand_saturation(x, u):
    s = (u.to(x.device, x.dtype) * 2.0).view(-1, 1, 1, 1)
    mean_c = x.mean(dim=1, keepdim=True)
    return (x - mean_c) * s + mean_c


def rand_contrast(x, u):
    c = (u.to(x.device, x.dtype) + 0.5).view(-1, 1, 1, 1)
    mean_all = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean_all) * c + mean_all


def _translation_range(h: int, w: int, ratio: float = 0.125):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_translation(x, shifts):
    """Per-sample integer shift (ty, tx), each in [-r, r] for r = 1/8 of the
    side, zero-padded (ref ``diffaugment_utils.py:66-87``)."""
    ty, tx = (t.to(x.device) for t in shifts)
    n, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    iy = torch.clamp(torch.arange(h, device=x.device)[None] + ty[:, None] + 1, 0, h + 1)
    ix = torch.clamp(torch.arange(w, device=x.device)[None] + tx[:, None] + 1, 0, w + 1)
    rows = xp.gather(2, iy[:, None, :, None].expand(n, c, h, w + 2))
    return rows.gather(3, ix[:, None, None, :].expand(n, c, h, w))


def _cutout_size(h: int, w: int, ratio: float = 0.5):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_cutout(x, centres):
    """Zero a (H/2, W/2) window per sample around centre (oy, ox), by a
    computed mask (ref ``diffaugment_utils.py:90-112``)."""
    oy, ox = (t.to(x.device) for t in centres)
    _, _, h, w = x.shape
    ch, cw = _cutout_size(h, w)
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    y0 = (oy - ch // 2)[:, None, None]
    x0 = (ox - cw // 2)[:, None, None]
    inside = (yy >= y0) & (yy < y0 + ch) & (xx >= x0) & (xx < x0 + cw)
    mask = torch.where(inside, 0.0, 1.0).to(x.dtype)
    return x * mask[:, None]


AUGMENT_FNS = {
    "color": [rand_brightness, rand_saturation, rand_contrast],
    "translation": [rand_translation],
    "cutout": [rand_cutout],
}


def _draw(fn, x, generator):
    n, _, h, w = x.shape
    kw = dict(generator=generator, device=x.device)
    if fn is rand_translation:
        sy, sx = _translation_range(h, w)
        return (torch.randint(-sy, sy + 1, (n,), **kw), torch.randint(-sx, sx + 1, (n,), **kw))
    if fn is rand_cutout:
        ch, cw = _cutout_size(h, w)
        return (torch.randint(0, h + (1 - ch % 2), (n,), **kw),
                torch.randint(0, w + (1 - cw % 2), (n,), **kw))
    return torch.rand((n,), dtype=x.dtype, **kw)


def _fns(policy: str):
    return [f for p in policy.split(",") for f in AUGMENT_FNS[p]] if policy else []


def _rows_like(x, n: int):
    """A stand-in for an ``n``-row batch of ``x``'s kind (shape, type,
    device), for its draws; no memory of its own."""
    return x[:1].expand(n, *x.shape[1:])


def augment_draws(policy: str, x, generator: Optional[torch.Generator] = None) -> List:
    """The draws ``diff_augment(x, policy)`` needs, from ``generator`` (on
    ``x``'s device), in policy order."""
    return [_draw(f, x, generator) for f in _fns(policy)]


def diff_augment(x, policy: str = "", generator: Optional[torch.Generator] = None,
                 draws: Optional[List] = None, parts: int = 1):
    """Apply the comma-separated ``policy`` (e.g. ``"color,translation,cutout"``)
    to an NCHW batch, with ``draws`` (one per function, in policy order) or
    fresh ones from ``generator``.  ``parts``: ``x`` stacks that many
    batches (matters only inside ``data_parallel``)."""
    fns = _fns(policy)
    if draws is None:
        # Inside ``parallel.collectives.data_parallel``: the draws of the
        # ``parts`` global batches, this rank's rows of each.
        draws = collectives.draw_rows(
            lambda n: augment_draws(policy, x if n == x.shape[0] else _rows_like(x, n),
                                    generator), x.shape[0], parts)
    if len(draws) != len(fns):
        raise ValueError(f"policy {policy!r} takes {len(fns)} draws, got {len(draws)}")
    for f, d in zip(fns, draws):
        x = f(x, d)
    return x
