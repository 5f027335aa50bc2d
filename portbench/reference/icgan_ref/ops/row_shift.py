"""Per-row fractional shift, the primitive of the ADA warp's shear passes,
in plain PyTorch: the port's plain version, differentiated by autograd to
any order (no kernel)."""

from __future__ import annotations

from typing import Optional

import torch


def row_shift_ref(x: torch.Tensor, off: torch.Tensor,
                  l_out: Optional[int] = None) -> torch.Tensor:
    """Plain version: two gathers from the zero-padded row and a lerp in
    float32 (or wider), returned in x's type.  x (B, L), off (B,) →
    (B, l_out).  A row whose finite shift reads nothing in frame comes out
    zero; a row whose offset is NaN or ±inf comes out NaN, as
    ``fast_warp._frac_shift_rows_2d`` of the JAX package and the kernel give
    (its fraction is NaN, and NaN·0 is NaN)."""
    B, L = x.shape
    l_out = L if l_out is None else l_out
    cd = torch.promote_types(x.dtype, torch.float32)
    off = off.to(torch.promote_types(off.dtype, torch.float32))
    k = torch.floor(off)
    in_frame = (k >= -l_out) & (k <= L)   # false for NaN and ±inf
    f = torch.where(in_frame, off - k,
                    torch.where(torch.isfinite(off), 0.0, float("nan"))).to(cd)[:, None]
    valid = in_frame.to(cd)[:, None]
    kc = torch.where(in_frame, k, 0.0).to(torch.int64)
    xp = torch.nn.functional.pad(x.to(cd), (l_out, l_out + 2))
    idx = l_out + kc[:, None] + torch.arange(l_out, device=x.device)[None, :]
    s0 = torch.gather(xp, 1, idx)
    s1 = torch.gather(xp, 1, idx + 1)
    return ((s0 * (1.0 - f) + s1 * f) * valid).to(x.dtype)


def row_shift(x: torch.Tensor, off: torch.Tensor,
              l_out: Optional[int] = None) -> torch.Tensor:
    """out[b, l] = x[b, l + off[b]] for l < l_out (default L), linear
    interpolation, zero outside [0, L)."""
    return row_shift_ref(x, off.to(torch.promote_types(off.dtype, torch.float32)), l_out)


def frac_shift_rows(x: torch.Tensor, off: torch.Tensor,
                    l_out: Optional[int] = None) -> torch.Tensor:
    """``row_shift`` over x (N, R, L, C) and off (N, R), the JAX package's
    layout: channels share their row's offset."""
    N, R, L, C = x.shape
    l_out = L if l_out is None else l_out
    rows = x.permute(0, 1, 3, 2).reshape(N * R * C, L)
    off_rows = off.reshape(N * R).repeat_interleave(C)
    out = row_shift(rows, off_rows, l_out)
    return out.reshape(N, R, C, l_out).permute(0, 1, 3, 2)
