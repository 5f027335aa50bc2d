"""The batch loader: port of ``ic_gan_tpu/native/build.py`` and
``native/fastloader.cpp``.

The JAX package converts a uint8 NCHW batch to normalized float32 NHWC on
the host in threaded C++ and copies the floats to the device.  Here the
uint8 batch goes to the device as it is stored (a quarter of the bytes),
is flipped along W where asked, and each value is mapped through a
256-entry float32 table on the device.  A uint8 has 256 values, so the
table, built once in numpy with the host's float32 arithmetic, gives the
host formula's results bit for bit whatever the device's compiler does with
``a*b + c``.  The layout stays NCHW (the JAX loader's NHWC is layout only).

Two formulas:
- ``"loader"``: the native loader's ``float(x)·(2/255) − 1``, two
  roundings (training batches, ``HDF5Dataset._prepare_images``);
- ``"norm"``: ``HDF5Dataset._norm``'s ``(x/255 − 0.5)·2`` (the moments and
  the eval's real images).
"""

from __future__ import annotations

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.utils.spans import span

FORMULAS = ("loader", "norm")


def norm_table(formula: str = "loader", apply_norm: bool = True) -> np.ndarray:
    """The 256 float32 results of ``formula`` (``apply_norm`` False: the
    values as floats)."""
    if formula not in FORMULAS:
        raise ValueError(f"formula must be one of {FORMULAS}, got {formula!r}")
    x = np.arange(256, dtype=np.float32)
    if not apply_norm:
        return x
    if formula == "loader":
        scale = np.float32(2.0) / np.float32(255.0)
        return x * scale + np.float32(-1.0)
    return (x / np.float32(255.0) - np.float32(0.5)) * np.float32(2.0)


_DEVICE_TABLES = {}


def _device_table(formula: str, apply_norm: bool, device: torch.device) -> torch.Tensor:
    key = (formula, apply_norm, device)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = torch.from_numpy(norm_table(formula, apply_norm)).to(device)
    return t


def normalize_batch(u8, hflip_mask=None, apply_norm: bool = True, device=None,
                    formula: str = "loader") -> torch.Tensor:
    """uint8 (B, C, H, W) (numpy or a tensor) → float32 (B, C, H, W) on
    ``device`` (default CUDA): flipped along W where ``hflip_mask`` (B,) is
    set, each value mapped through ``norm_table(formula, apply_norm)``."""
    with span("data/normalize_batch"):
        device = resolve_device(device)
        x = torch.as_tensor(u8)
        if x.dtype != torch.uint8 or x.dim() != 4:
            raise ValueError(f"normalize_batch takes uint8 (B, C, H, W), got {x.dtype} "
                             f"{tuple(x.shape)}")
        x = x.to(device)
        if hflip_mask is not None:
            m = torch.as_tensor(np.asarray(hflip_mask, bool)).to(device)
            x = torch.where(m[:, None, None, None], x.flip(3), x)
        table = _device_table(formula, bool(apply_norm), device)
        return table[x.int()]


def gather_rows(src, indices, device=None) -> torch.Tensor:
    """float32 rows ``src[indices]`` on ``device`` (default CUDA), an
    ``index_select`` there (the feature-bank lookup); an index out of range
    raises ``IndexError``, as the native gather does."""
    device = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32).to(device)
    idx = torch.as_tensor(np.asarray(indices, np.int64).reshape(-1)).to(device)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError("gather index out of range")
    return src.index_select(0, idx)
