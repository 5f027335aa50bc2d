"""The plain reference and the comparison that decides ``correct``.

``icgan_ref`` is a frozen copy of the port's plain paths (see its
docstring).  This module holds what the drivers compare with: the float32
mode the reference runs in, the float8 control that stands for the next
precision below bfloat16 where the program has no such path of its own, and
the gap measures.  Nothing here imports the port, JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_exact():
    """Float32 products with TF32 off, as the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 (e4m3) under one scale for the tensor, the
    straight-through way: the forward sees the rounded values, the
    gradient passes as if unrounded."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


@contextlib.contextmanager
def fp8_operands():
    """Every convolution, linear map and matrix product inside the block takes
    its operands rounded to float8: the reference computed in the next
    precision below bfloat16 (the control of a bfloat16 cell)."""
    conv, linear, matmul, bmm, mm = F.conv2d, F.linear, torch.matmul, torch.bmm, torch.mm
    t_matmul = torch.Tensor.__matmul__

    def q_args(fn):
        def wrapped(a, b, *rest, **kw):
            return fn(fp8_round(a), fp8_round(b), *rest, **kw)
        return wrapped

    F.conv2d, F.linear = q_args(conv), q_args(linear)
    torch.matmul, torch.bmm, torch.mm = q_args(matmul), q_args(bmm), q_args(mm)
    torch.Tensor.__matmul__ = q_args(t_matmul)
    try:
        yield
    finally:
        F.conv2d, F.linear, torch.matmul, torch.bmm, torch.mm = conv, linear, matmul, bmm, mm
        torch.Tensor.__matmul__ = t_matmul


def image_gaps(pairs) -> dict:
    """Over (got, ref) pairs of NHWC image batches, each over the mean
    |ref| of all the images: ``mean``, mean |got − ref|; ``worst``, the
    largest single image's mean |got − ref|; ``median``, the median image's;
    ``drift``, the mean over pixels of |mean over images of (got − ref)|,
    the error that does not average out over images; ``max``, the largest
    |got − ref| of any value."""
    per_image, drift_sum, n, den, mx = [], 0.0, 0, 0.0, 0.0
    for got, ref in pairs:
        d = got.float() - ref.float()
        per_image.append(d.abs().flatten(1).mean(dim=1))
        drift_sum = drift_sum + d.sum(dim=0)
        n += d.shape[0]
        den += float(ref.float().abs().flatten(1).mean(dim=1).sum())
        mx = max(mx, float(d.abs().max()))
    per_image = torch.cat(per_image)
    scale = den / n
    return dict(mean=float(per_image.mean()) / scale, worst=float(per_image.max()) / scale,
                median=float(per_image.median()) / scale,
                drift=float((drift_sum / n).abs().mean()) / scale, max=mx / scale)


def leaf_gaps(got: dict, ref: dict, keys=None) -> dict:
    """Each leaf's |‖got‖ − ‖ref‖| over the larger of ‖ref‖ of that leaf and
    of the median leaf; ``got`` and ``ref`` map leaf names to norms."""
    keys = sorted(ref if keys is None else keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def checks_of(values: dict, limits, where=None) -> list:
    """The compared numbers: those that the cell's limits name, each with
    its limit (all of ``values``, unbounded, where ``limits`` is None, as
    the readings that limits are set from are taken)."""
    names = values if limits is None else limits
    where = where or {}
    return [dict(name=n, value=values[n], limit=math.inf if limits is None else limits[n],
                 ok=limits is None or values[n] <= limits[n], where=where.get(n, ""))
            for n in names]
