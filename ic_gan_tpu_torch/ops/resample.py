"""BigGAN resampling in NCHW: nearest 2× upsample, the polyphase
upsample-conv, 2×2 max and average pools and the pooled downsample-conv.
Port of the BigGAN subset of ``ic_gan_tpu/ops/resample.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample (BigGAN G: ``F.interpolate``)."""
    n, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
    return x.reshape(n, c, 2 * h, 2 * w)


# Output parity (di, dj) of each phase, in the order the phases interleave.
_PHASE_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def polyphase_up_kernels(w: torch.Tensor) -> list:
    """The four 2×2 phase kernels (OIHW) of ``conv3x3_nearest_up``, in
    ``_PHASE_OFFSETS`` order.  Even outputs read source rows (i-1, i) with
    taps (w0, w1+w2); odd outputs read (i, i+1) with (w0+w1, w2)."""
    a0 = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]], dtype=w.dtype,
                      device=w.device)
    a1 = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=w.dtype,
                      device=w.device)
    return [torch.einsum("ra,oiab,cb->oirc", ar, w, ac)
            for ar in (a0, a1) for ac in (a0, a1)]


def conv3x3_nearest_up(x: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor = None) -> torch.Tensor:
    """``conv3x3(upsample_nearest_2x(x), w, bias, padding=1)`` without the
    upsampled temp: four 2×2 convs on the source image, one per output
    parity, then a pixel interleave.  16 instead of 36 MACs per output,
    exact up to float associativity.

    x: (N, Cin, H, W); w: (Cout, Cin, 3, 3) → (N, Cout, 2H, 2W).
    """
    if w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3_nearest_up needs a 3x3 kernel, got {tuple(w.shape)}")
    phases = []
    for (di, dj), k in zip(_PHASE_OFFSETS, polyphase_up_kernels(w)):
        # Asymmetric SAME padding of the phase: (1-d) before, d after.
        xp = F.pad(x, (1 - dj, dj, 1 - di, di))
        phases.append(F.conv2d(xp, k, bias))
    return _interleave_phases(phases, x.shape)


def _interleave_phases(phases, x_shape):
    n, _, h, w = x_shape
    y = torch.stack(phases).reshape(2, 2, n, -1, h, w)
    y = y.permute(2, 3, 4, 0, 5, 1)  # N, C, H, di, W, dj
    return y.reshape(n, -1, 2 * h, 2 * w)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 max pool, stride 2 (SA-GAN attention φ/g path)."""
    return F.max_pool2d(x, 2)


# Tap r of the 4×4 box-convolved kernel sums rows r and r−1 of the 3×3 one.
_BOX_TAPS = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))


def conv3x3_avg_pool_down(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor = None) -> torch.Tensor:
    """``avg_pool_2x(conv3x3(x, w, padding=1)) + bias`` as one stride-2 conv
    with the 4×4 kernel ¼·w⊛1₂ₓ₂ and padding (1, 1): the BigGAN DBlock tail
    without the full-resolution conv temp, exact up to float associativity.

    x: (N, Cin, H, W); w: (Cout, Cin, 3, 3) → (N, Cout, H/2, W/2).
    """
    if w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3_avg_pool_down needs a 3x3 kernel, got {tuple(w.shape)}")
    b = torch.tensor(_BOX_TAPS, dtype=w.dtype, device=w.device)  # (4, 3)
    k4 = 0.25 * torch.einsum("ra,oiab,cb->oirc", b, w, b)
    return F.conv2d(x, k4, bias, stride=2, padding=1)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool, stride 2 (BigGAN D: ``nn.AvgPool2d(2)``)."""
    return F.avg_pool2d(x, 2)
