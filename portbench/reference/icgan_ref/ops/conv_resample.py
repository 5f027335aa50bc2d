"""2-D convolution with fused up/down-sampling, NCHW and OIHW.

Port of ``ic_gan_tpu/ops/conv_resample.py`` (reference
``torch_utils/ops/conv2d_resample.py:79-216``), with its two fast paths:

- up 2 with a 3×3 kernel and a 4-tap symmetric filter: the zero-stuffed
  convolution followed by the FIR equals one convolution with the composite
  kernel w ⊛ f, split by output parity into four 3×3 phase kernels that run
  at the input's resolution, then interleaved;
- down 2 with a 4-tap symmetric filter: the FIR followed by the strided
  convolution equals one strided convolution with w ⊛ f.

Both are exact up to float associativity.  Other geometries take the
generic route: ``upfirdn2d`` and a dense convolution.  The composite kernels
are formed in float32, as the JAX package forms them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.icgan_ref.ops.resample import _filter_size, _quad, upfirdn2d


def is_symmetric(f: Optional[torch.Tensor]) -> bool:
    """True iff the filter equals its flip (read once, where a layer is
    built: the fast paths correlate where the FIR convolves)."""
    return f is not None and bool(torch.allclose(f, f.flip(list(range(f.dim())))))


def _compose_kernel(w: torch.Tensor, f2d: torch.Tensor) -> torch.Tensor:
    """Full 2-D convolution of each (o, i) tap plane of ``w`` (O, I, kh, kw)
    with ``f2d`` (fh, fw) → (O, I, kh+fh−1, kw+fw−1), float32."""
    o, i, kh, kw = w.shape
    fh, fw = f2d.shape
    planes = w.to(torch.float32).reshape(o * i, 1, kh, kw)
    k = F.conv2d(planes, f2d.to(torch.float32).flip(0, 1)[None, None],
                 padding=(fh - 1, fw - 1))
    return k.reshape(o, i, kh + fh - 1, kw + fw - 1)


def _conv(x, w, stride=1, pad=(0, 0, 0, 0), groups=1):
    """Dense convolution with (x0, x1, y0, y1) zero padding (all ≥ 0)."""
    px0, px1, py0, py1 = pad
    if px0 == px1 and py0 == py1:
        return F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    return F.conv2d(F.pad(x, (px0, px1, py0, py1)), w, stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None,
                    up: int = 1, down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True,
                    f_symmetric: Optional[bool] = None) -> torch.Tensor:
    """x (N, I, H, W), w (O, I/groups, kh, kw); ``padding`` as the reference
    (int, (x, y) or (x0, x1, y0, y1)).  ``flip_weight=True`` correlates, as
    ``F.conv2d``; False flips the kernel.  ``f_symmetric`` may pass
    ``is_symmetric(f)`` computed ahead, so that no call reads the filter
    back from the device."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw, fh = _filter_size(f)
    px0, px1, py0, py1 = _quad(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    if not flip_weight:
        w = w.flip(2, 3)
    w = w.to(x.dtype)
    if f_symmetric is None:
        f_symmetric = is_symmetric(f)

    if up > 1:
        if (up == 2 and down == 1 and groups == 1 and f is not None and (kh, kw) == (3, 3)
                and tuple(f.shape) in ((4,), (4, 4)) and (py0, py1, px0, px1) == (3, 2, 3, 2)
                and f_symmetric):
            f2d = torch.outer(f, f) if f.dim() == 1 else f
            k = _compose_kernel(w, f2d * float(up * up))  # (O, I, 6, 6)
            phases = [k[:, :, (py0 - a) % 2::2, (px0 - b) % 2::2] for a in (0, 1) for b in (0, 1)]
            y = F.conv2d(x, torch.cat(phases).to(x.dtype), padding=1)  # (N, 4·O, H, W)
            n, _, h, wd = x.shape
            y = y.reshape(n, 2, 2, -1, h, wd).permute(0, 3, 4, 1, 5, 2)  # N, O, H, a, W, b
            return y.reshape(n, -1, 2 * h, 2 * wd)
        # Zero-stuff and pad, dense conv, then the FIR at the output's rate.
        y = _conv(upfirdn2d(x, None, up=up, padding=(px0, px1, py0, py1)), w, groups=groups)
        y = upfirdn2d(y, f, gain=up * up) if f is not None else y * float(up * up)
        return upfirdn2d(y, f, down=down) if down > 1 else y

    if down > 1:
        if (down == 2 and groups == 1 and f is not None and tuple(f.shape) in ((4,), (4, 4))
                and min(px0, px1, py0, py1) >= 0 and f_symmetric):
            f2d = torch.outer(f, f) if f.dim() == 1 else f
            k = _compose_kernel(w, f2d).to(x.dtype)
            return _conv(x, k, stride=down, pad=(px0, px1, py0, py1))
        return _conv(upfirdn2d(x, f, padding=(px0, px1, py0, py1)), w, stride=down,
                     groups=groups)

    if min(px0, px1, py0, py1) >= 0:
        return _conv(x, w, pad=(px0, px1, py0, py1), groups=groups)
    return _conv(upfirdn2d(x, None, padding=(px0, px1, py0, py1)), w, groups=groups)
