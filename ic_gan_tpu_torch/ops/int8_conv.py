"""int8 × int8 → int32 convolution, NCHW input and OIHW kernel.

The int8 serving mode (``io/quant.py``) runs its convolutions here.  The
JAX package has no module for this: it calls
``jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``
inline, and XLA sums the products exactly in int32.  ``conv2d_int8`` gives
the same exact sums.  On the card it copies the input's k×k windows once into
an int8 im2col matrix and multiplies it by the kernel with ``torch._int_mm``
(int8 × int8 → int32 on the tensor cores), a chunk of the batch at a time so
that the im2col stays under ``CHUNK_BYTES``.  ``_int_mm`` takes more than 16
rows and a depth and width that are multiples of 8: the wrapper pads rows,
depth and width with zeros, which leaves the sums as they are.  On CPU
tensors it runs its plain version, ``conv2d_int8_ref``.

No Pallas kernel is ported here: the product is the int8 counterpart of a
plain large matrix product.  A hand-written implicit-GEMM conv, which would
skip the im2col's round trip through device memory, waits for a profile of
this route (``ROADMAP.md`` §B).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bytes of im2col a chunk of the batch may take on the card.
CHUNK_BYTES = 1 << 30


def _pads(padding) -> tuple:
    """int or (top, bottom, left, right) → F.pad's (left, right, top, bottom)."""
    if isinstance(padding, int):
        return (padding,) * 4
    y0, y1, x0, x1 = padding
    return (x0, x1, y0, y1)


def _check(xq: torch.Tensor, qk: torch.Tensor):
    if xq.dtype != torch.int8 or qk.dtype != torch.int8:
        raise ValueError(f"conv2d_int8 takes int8 input and kernel, got {xq.dtype}, {qk.dtype}")
    if xq.dim() != 4 or qk.dim() != 4 or xq.shape[1] != qk.shape[1]:
        raise ValueError(f"shapes do not fit: input {tuple(xq.shape)} (N, C, H, W), "
                         f"kernel {tuple(qk.shape)} (O, C, kh, kw)")
    if xq.device != qk.device:
        raise ValueError(f"input and kernel must lie on one device, got {xq.device}, {qk.device}")


def conv2d_int8_ref(xq: torch.Tensor, qk: torch.Tensor, padding=0) -> torch.Tensor:
    """Plain version: the convolution in float64, whose sums of int8 products
    are exact (each below 2⁵³ in magnitude), returned as int32."""
    _check(xq, qk)
    x = F.pad(xq.to(torch.float64), _pads(padding))
    return F.conv2d(x, qk.to(torch.float64)).to(torch.int32)


def conv2d_int8(xq: torch.Tensor, qk: torch.Tensor, padding=0) -> torch.Tensor:
    """Stride-1 convolution of int8 ``xq`` (N, C, H, W) with the int8 kernel
    ``qk`` (O, C, kh, kw), zero ``padding`` an int or (top, bottom, left,
    right), summed exactly → int32 (N, O, Ho, Wo).  CPU tensors take the
    plain version; CUDA tensors run the im2col and ``torch._int_mm``, whose
    (N, Ho, Wo, O) result comes back as an NCHW view."""
    if xq.device.type == "cpu":
        return conv2d_int8_ref(xq, qk, padding)
    _check(xq, qk)
    return im2col_int_mm(xq, qk, padding)


def im2col_int_mm(xq: torch.Tensor, qk: torch.Tensor, padding=0) -> torch.Tensor:
    """The card's route of ``conv2d_int8`` on any device (``torch._int_mm``
    runs on the CPU too, so the tests hold its im2col and padding there)."""
    xp = F.pad(xq, _pads(padding))
    n, c, hp, wp = xp.shape
    o, _, kh, kw = qk.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    k = c * kh * kw
    kp, op = k + (-k % 8), o + (-o % 8)
    w = qk.reshape(o, k)
    if (kp, op) != (k, o):
        w = F.pad(w, (0, kp - k, 0, op - o))
    wt = w.t()                                   # (K, O), column-major as _int_mm wants
    chunk = max(1, CHUNK_BYTES // (ho * wo * kp))
    outs = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        m = (hi - lo) * ho * wo
        mp = max(m, 17)
        windows = xp[lo:hi].unfold(2, kh, 1).unfold(3, kw, 1)   # (b, C, Ho, Wo, kh, kw)
        a = windows.permute(0, 2, 3, 1, 4, 5).reshape(m, k)       # the one copy
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        y = torch._int_mm(a, wt)
        if (mp, op) != (m, o):
            y = y[:m, :o]
        outs.append(y.reshape(hi - lo, ho, wo, o))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out.permute(0, 3, 1, 2)
