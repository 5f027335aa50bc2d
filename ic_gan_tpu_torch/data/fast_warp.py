"""Gather-free affine image warp (Catmull-Smith two-pass), NCHW.

Port of ``ic_gan_tpu/data/fast_warp.py``.  The per-sample inverse affine
``src_px = A @ dst_px + t`` is applied as

  1. an axis swap (per-sample transpose select) when the affine is closer to
     a 90° rotation, so the vertical scale stays well-conditioned;
  2. pass 1 (vertical): a per-sample 1-D scale resample as a batched
     (L_out × L_in) matrix product, then a per-column fractional shear
     (``ops.row_shift``, kernel B3 on the card);
  3. pass 2 (horizontal): the same along the other axis.

With ``[gx; gy] = A·[xo; yo] + t`` and ``A = [[a, b], [c, d]]``:
``T[yt, x] = img[α·yt + ε·x + ζ, x]``, then ``out[yo, xo] = T[yo, a·xo + b·yo
+ tx]``, with ``ε = c/a``, ``α = d − cb/a``, ``ζ = ty − ε·tx``.  The warp runs
planar, (N, C, row, shifted axis), so the shifted axis is always the last.
"""

from __future__ import annotations

import torch

from ic_gan_tpu_torch.ops.row_shift import row_shift


def _shift_planar(x: torch.Tensor, off: torch.Tensor, l_out: int) -> torch.Tensor:
    """Per-row fractional shift of x (N, C, R, L) by off (N, R) → (N, C, R,
    l_out); channels share their row's offset."""
    n, c, r, length = x.shape
    rows = x.reshape(n * c * r, length)
    off_rows = off[:, None, :].expand(n, c, r).reshape(-1)
    return row_shift(rows, off_rows, l_out).reshape(n, c, r, l_out)


def _scale_rows_planar(x: torch.Tensor, alpha: torch.Tensor, r0: torch.Tensor,
                       l_out: int) -> torch.Tensor:
    """out[lo] = x[α·lo + r0] along the last axis (linear, zero outside),
    per sample: x (N, C, R, L), alpha and r0 (N,) → (N, C, R, l_out) in
    float32 or wider.  The weights are formed in float32 or wider (positions
    need the mantissa); the product runs in x's type."""
    n, c, r, length = x.shape
    wd = torch.promote_types(alpha.dtype, torch.float32)
    lo = torch.arange(l_out, dtype=wd, device=x.device)
    li = torch.arange(length, dtype=wd, device=x.device)
    pos = alpha[:, None].to(wd) * lo[None, :] + r0[:, None].to(wd)          # (N, Lo)
    w = torch.clamp_min(1.0 - (pos[:, :, None] - li[None, None, :]).abs(), 0.0)
    out = torch.matmul(x.reshape(n, c * r, length), w.to(x.dtype).transpose(1, 2))
    return out.reshape(n, c, r, l_out).to(torch.promote_types(x.dtype, torch.float32))


def affine_warp(img: torch.Tensor, A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Warp img (N, C, H, W), H == W, by the per-sample inverse affine
    (pixel coordinates) A (N, 2, 2), t (N, 2).  Same shape and type out."""
    n, c, h, w = img.shape
    if h != w:
        raise ValueError(f"affine_warp needs square images (ADA pads to square), got {h}x{w}")
    a, b, cc, d = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    tx, ty = t[:, 0], t[:, 1]

    # Planar (N, C, x, y): pass 1 resamples and shifts y, the last axis.  The
    # swapped sample is the transposed image, whose planar form is NCHW.
    swap = a.abs() < cc.abs()
    x_sel = torch.where(swap[:, None, None, None], img, img.transpose(2, 3))
    a_, b_ = torch.where(swap, cc, a), torch.where(swap, d, b)
    c_, d_ = torch.where(swap, a, cc), torch.where(swap, b, d)
    tx_, ty_ = torch.where(swap, ty, tx), torch.where(swap, tx, ty)

    eps = 1e-8
    a_safe = torch.where(a_.abs() < eps, torch.full_like(a_, eps), a_)
    e = c_ / a_safe
    alpha = d_ - e * b_
    alpha_safe = torch.where(alpha.abs() < eps, torch.full_like(alpha, eps), alpha)
    zeta = ty_ - e * tx_

    length = h
    ext = 2 * length  # the extended intermediate window covers [-L/2, 3L/2)
    pos = torch.arange(w, dtype=torch.float32, device=img.device)

    # Pass 1 (vertical): the scale product first (it sees the whole source
    # axis), then the per-column shear.  S[x, j] = img[α·(j − L/2) + ζ, x].
    S = _scale_rows_planar(x_sel, alpha, zeta - alpha * (length / 2.0), ext)
    off1 = length / 2.0 + (e / alpha_safe)[:, None] * pos[None, :]      # (N, W)
    T = _shift_planar(S, off1, length).transpose(2, 3)                  # (N, C, yt, x)

    # Pass 2 (horizontal): out[yo, xo] = T[yo, a·xo + b·yo + tx].
    U = _scale_rows_planar(T, a_, tx_ - a_ * (length / 2.0), ext)
    off2 = length / 2.0 + (b_ / a_safe)[:, None] * pos[None, :]         # (N, H)
    return _shift_planar(U, off2, length).to(img.dtype)                 # (N, C, yo, xo)
