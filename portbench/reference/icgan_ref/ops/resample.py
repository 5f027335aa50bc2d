"""Resampling in NCHW.  Port of ``ic_gan_tpu/ops/resample.py``: the BigGAN
subset (nearest 2× upsample, the polyphase upsample-conv,
2×2 max and average pools, the pooled downsample-conv) and the StyleGAN2
subset (``setup_filter`` and the ``upfirdn2d`` family).

``upfirdn2d`` takes the upstream formulation (``torch_utils/ops/
upfirdn2d.py``): zero-upsample, pad (negative pads crop), FIR as depthwise
convolutions (two 1-D passes for a separable filter), downsample as the
convolution's stride; its backward is ``upfirdn2d`` again, as upstream's.
As in the JAX package it computes in float32 and returns the input's type.
It runs on small channel counts only (images and the ADA canvas); the
models' up/down convs fold their filter into the convolution
(``ops/conv_resample.py``).
"""

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


# --- StyleGAN2: FIR filters and upfirdn2d -------------------------------------------


def _pair(x) -> tuple:
    if isinstance(x, (tuple, list)):
        assert len(x) == 2
        return tuple(x)
    return (x, x)


def _quad(x) -> tuple:
    """int, (x, y) or (x0, x1, y0, y1) → (x0, x1, y0, y1)."""
    if isinstance(x, (tuple, list)):
        if len(x) == 2:
            return (x[0], x[1], x[0], x[1])
        assert len(x) == 4
        return tuple(x)
    return (x, x, x, x)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable=None) -> torch.Tensor:
    """A FIR filter as a float32 CPU tensor (reference ``upfirdn2d.py:
    52-100``): ``(taps,)`` when separable (every 1-D filter, as in the JAX
    package), else ``(fh, fw)``."""
    f = torch.as_tensor(1.0 if f is None else f, dtype=torch.float32)
    assert f.dim() in (0, 1, 2)
    if f.dim() == 0:
        f = f[None]
    if separable is None:
        separable = f.dim() == 1
    if f.dim() == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.dim())))
    return f * (gain ** (f.dim() / 2))


def _filter_size(f):
    if f is None:
        return 1, 1
    if f.dim() == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[1]), int(f.shape[0])


def upfirdn2d(x: torch.Tensor, f, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Zero-upsample by ``up``, pad by ``padding`` ((x0, x1, y0, y1), as the
    reference), convolve with the FIR ``f`` (correlate when ``flip_filter``)
    and downsample by ``down``.  x (N, C, H, W) → (N, C, outH, outW) with
    ``outH = (H·upy + pady0 + pady1 − fh) // downy + 1``; ``up``, ``down``:
    an int or (y, x).  Differentiable in x to any order; ``f`` is a constant.
    """
    return _Upfirdn2d.apply(x, f, _pair(up), _pair(down), _quad(padding), flip_filter, gain)


class _Upfirdn2d(torch.autograd.Function):
    """The op, whose backward is the op again with up and down swapped, the
    padding complemented and the filter flipped (reference
    ``upfirdn2d.py:325-349``).  So every derivative, the second order that R1
    and path length take included, runs as forward FIR convolutions: the
    double backward of a grouped ``conv2d`` falls to a generic float32
    kernel that is two orders of magnitude slower."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        y = _upfirdn2d_forward(x, f, up, down, padding, gain, flip_filter)
        ctx.f, ctx.args = f, (up, down, padding, flip_filter, gain)
        ctx.shapes = (x.shape, y.shape)
        return y

    @staticmethod
    def backward(ctx, dy):
        (upy, upx), (downy, downx), (padx0, _, pady0, _), flip_filter, gain = ctx.args
        (_, _, in_h, in_w), (_, _, out_h, out_w) = ctx.shapes
        fw, fh = _filter_size(ctx.f)
        p = (fw - padx0 - 1, upx * in_w - out_w * downx + padx0 - upx + 1,
             fh - pady0 - 1, upy * in_h - out_h * downy + pady0 - upy + 1)
        dx = upfirdn2d(dy, ctx.f, up=(downy, downx), down=(upy, upx), padding=p,
                       flip_filter=not flip_filter, gain=gain)
        return dx, None, None, None, None, None, None


def _upfirdn2d_forward(x, f, up, down, padding, gain, flip_filter):
    (upy, upx), (downy, downx) = up, down
    padx0, padx1, pady0, pady1 = padding
    in_dtype = x.dtype
    x = x.to(torch.float32)
    n, c, h, w = x.shape
    if upx > 1 or upy > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), (0, upx - 1, 0, 0, 0, upy - 1))
        x = x.reshape(n, c, h * upy, w * upx)
    x = F.pad(x, (max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)))
    x = x[:, :, max(-pady0, 0):x.shape[2] - max(-pady1, 0),
          max(-padx0, 0):x.shape[3] - max(-padx1, 0)]
    if f is None:
        return (x[:, :, ::downy, ::downx] * gain).to(in_dtype)
    f = f.to(device=x.device, dtype=torch.float32)
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    if f.dim() == 2:
        k = f[None, None].expand(c, 1, *f.shape)
        y = F.conv2d(x, k, stride=(downy, downx), groups=c)
    else:
        y = F.conv2d(x, f[None, None, None, :].expand(c, 1, 1, -1), stride=(1, downx), groups=c)
        y = F.conv2d(y, f[None, None, :, None].expand(c, 1, -1, 1), stride=(downy, 1), groups=c)
    return (y * gain).to(in_dtype)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """FIR filter with no resampling, padded so that an odd filter keeps the
    size (reference ``upfirdn2d.py:359-389``)."""
    padx0, padx1, pady0, pady1 = _quad(padding)
    fw, fh = _filter_size(f)
    p = (padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Filtered upsample (reference ``upfirdn2d.py:392-438``)."""
    upy, upx = _pair(up)
    padx0, padx1, pady0, pady1 = _quad(padding)
    fw, fh = _filter_size(f)
    p = (padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2)
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Filtered downsample (reference ``upfirdn2d.py:441-487``)."""
    downy, downx = _pair(down)
    padx0, padx1, pady0, pady1 = _quad(padding)
    fw, fh = _filter_size(f)
    p = (padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2)
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
