"""Per-row fractional shift, the primitive of the ADA warp's shear passes.

Port of ``ic_gan_tpu/ops/pallas/row_shift.py``.  ``row_shift(x, off, l_out)``
computes ``out[b, l] = x[b, l + off[b]]`` for ``l < l_out`` with linear
interpolation and zero outside ``[0, L)``.  It is ``RowShift.apply``: on CUDA
tensors its forward launches ``csrc/row_shift.cu``, on CPU tensors it runs
the plain version ``row_shift_ref`` (``fast_warp._frac_shift_rows_2d`` of
the JAX package).  The op is linear in ``x``, and its adjoint is the same op
with ``-off`` from a row of ``l_out`` to one of ``L``; the backward calls
``RowShift.apply`` itself, so the op differentiates to any order (R1 takes a
gradient through the augmentation and then differentiates it again).  ``off``
gets no gradient.  Each launch adds one to ``row_shift_fwd.launches`` and to
``row_shift_fwd.launches_by_order[order]``: 0 for a forward, 1 for the
adjoint taken in a backward, 2 for the adjoint of that, and so on.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from ic_gan_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def row_shift_ref(x: torch.Tensor, off: torch.Tensor,
                  l_out: Optional[int] = None) -> torch.Tensor:
    """Plain version: two gathers from the zero-padded row and a lerp in
    float32 (or wider), returned in x's type.  x (B, L), off (B,) →
    (B, l_out)."""
    B, L = x.shape
    l_out = L if l_out is None else l_out
    cd = torch.promote_types(x.dtype, torch.float32)
    off = off.to(torch.promote_types(off.dtype, torch.float32))
    k = torch.floor(off)
    f = (off - k).to(cd)[:, None]
    valid = ((k >= -l_out) & (k <= L)).to(cd)[:, None]
    kc = torch.clamp(k, -l_out, L).to(torch.int64)
    xp = torch.nn.functional.pad(x.to(cd), (l_out, l_out + 2))
    idx = l_out + kc[:, None] + torch.arange(l_out, device=x.device)[None, :]
    s0 = torch.gather(xp, 1, idx)
    s1 = torch.gather(xp, 1, idx + 1)
    return ((s0 * (1.0 - f) + s1 * f) * valid).to(x.dtype)


def _entry():
    fn = _build.load("row_shift").row_shift
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def row_shift_fwd(x: torch.Tensor, off: torch.Tensor, l_out: Optional[int] = None,
                  order: int = 0) -> torch.Tensor:
    """The shift alone, no autograd.  CPU tensors take ``row_shift_ref``;
    CUDA tensors launch the kernel on the current stream, or raise.
    ``order`` only labels the launch count."""
    if x.device.type == "cpu" and off.device.type == "cpu":
        return row_shift_ref(x, off, l_out)
    if x.dim() != 2 or off.shape != (x.shape[0],):
        raise ValueError(f"row_shift takes x (B, L) and off (B,), got {tuple(x.shape)} "
                         f"and {tuple(off.shape)}")
    B, L = x.shape
    l_out = L if l_out is None else int(l_out)
    if x.device.type != "cuda" or off.device != x.device:
        raise ValueError(f"x and off must lie on one CUDA device, got {x.device} "
                         f"and {off.device}")
    if x.dtype not in _DTYPE_CODES or off.dtype != torch.float32:
        raise ValueError(f"row_shift takes float32 or bfloat16 x and float32 off, got "
                         f"{x.dtype} and {off.dtype}")
    if not (x.is_contiguous() and off.is_contiguous()):
        raise ValueError("x and off must be contiguous")
    if not (0 < B < 2 ** 31 and 0 < L < 2 ** 30 and 0 < l_out < 2 ** 30):
        raise ValueError(f"row_shift takes 0 < B < 2^31 and 0 < L, l_out < 2^30, got "
                         f"B {B}, L {L}, l_out {l_out}")
    out = torch.empty((B, l_out), dtype=x.dtype, device=x.device)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), off.data_ptr(), out.data_ptr(), B, L, l_out,
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"row_shift launch failed: cudaError {err}")
    row_shift_fwd.launches += 1
    row_shift_fwd.launches_by_order[order] += 1
    return out


row_shift_fwd.launches = 0
row_shift_fwd.launches_by_order = collections.Counter()


def reset_launches():
    row_shift_fwd.launches = 0
    row_shift_fwd.launches_by_order.clear()


class RowShift(torch.autograd.Function):
    """The shift, whose backward is the shift again (with ``-off``, from
    ``l_out`` back to ``L``), through this Function, to any order."""

    @staticmethod
    def forward(ctx, x, off, l_out, order):
        ctx.save_for_backward(off)
        ctx.L, ctx.order = x.shape[1], order
        return row_shift_fwd(x.contiguous(), off.contiguous(), l_out, order)

    @staticmethod
    def backward(ctx, grad):
        (off,) = ctx.saved_tensors
        return RowShift.apply(grad, -off, ctx.L, ctx.order + 1), None, None, None


def row_shift(x: torch.Tensor, off: torch.Tensor,
              l_out: Optional[int] = None) -> torch.Tensor:
    """out[b, l] = x[b, l + off[b]] for l < l_out (default L), linear
    interpolation, zero outside [0, L).  x (B, L) float32 or bfloat16, off
    (B,) pixels, float32 or wider → (B, l_out) in x's type."""
    return RowShift.apply(x, off.to(torch.promote_types(off.dtype, torch.float32)),
                          x.shape[1] if l_out is None else int(l_out), 0)


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
