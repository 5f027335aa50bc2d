"""SA-GAN attention, o = softmax(θ·φᵀ)·g, in the JAX package's (N, L, d)
layout.

``sagan_attention`` launches the CUDA kernel ``csrc/sagan_attention_fwd.cu``
(the port of ``ic_gan_tpu/ops/pallas/attention.py:_attn_kernel``) on CUDA
tensors, and runs ``sagan_attention_ref``, its plain PyTorch version, on CPU
tensors.  Unscaled, non-causal.  Forward only: the backward kernel comes
with BigGAN training.
"""

from __future__ import annotations

import ctypes

import torch

from ic_gan_tpu_torch.ops import _build

_KERNEL = "sagan_attention_fwd"
MAX_D = 128
MAX_DV = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sagan_attention_ref(theta: torch.Tensor, phi: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Plain version, as ``_attention_xla``: f32 logits and softmax, p cast
    to g's type, second product accumulated in f32, output in g's type."""
    logits = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(g.dtype).float(), g.float()).to(g.dtype)


def _check(theta, phi, g):
    if not (theta.device == phi.device == g.device):
        raise ValueError("theta, phi and g must lie on one device, got "
                         f"{theta.device}, {phi.device}, {g.device}")
    if theta.device.type != "cuda":
        raise ValueError(f"sagan_attention runs on CPU or CUDA, not {theta.device}")
    if not (theta.dtype == phi.dtype == g.dtype) or g.dtype not in _DTYPE_CODES:
        raise ValueError("theta, phi and g must share one dtype of float32 or "
                         f"bfloat16, got {theta.dtype}, {phi.dtype}, {g.dtype}")
    if theta.dim() != 3 or phi.dim() != 3 or g.dim() != 3:
        raise ValueError("theta, phi and g must be (N, L, d) tensors")
    n, _, d = theta.shape
    if phi.shape[0] != n or g.shape[0] != n or phi.shape[2] != d \
            or g.shape[1] != phi.shape[1]:
        raise ValueError(f"shapes do not fit: theta {tuple(theta.shape)}, "
                         f"phi {tuple(phi.shape)}, g {tuple(g.shape)}")
    if not (0 < d <= MAX_D and 0 < g.shape[2] <= MAX_DV):
        raise ValueError(f"the kernel takes d <= {MAX_D} and dv <= {MAX_DV}, "
                         f"got d {d}, dv {g.shape[2]}")
    if not (0 < n <= 65535 and theta.shape[1] > 0 and phi.shape[1] > 0):
        raise ValueError(f"the kernel takes 0 < N <= 65535 and non-empty "
                         f"sequences, got {tuple(theta.shape)}, {tuple(phi.shape)}")
    if not (theta.is_contiguous() and phi.is_contiguous() and g.is_contiguous()):
        raise ValueError("theta, phi and g must be contiguous")


def _lib():
    lib = _build.load(_KERNEL)
    fn = lib.sagan_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sagan_attention(theta: torch.Tensor, phi: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """softmax(θ·φᵀ)·g.  θ (N, Lq, d), φ (N, Lk, d), g (N, Lk, dv) →
    (N, Lq, dv) in g's type.

    CPU tensors take the plain version.  CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback.  Each launch adds
    one to ``sagan_attention.launches``.
    """
    if theta.device.type == phi.device.type == g.device.type == "cpu":
        return sagan_attention_ref(theta, phi, g)
    _check(theta, phi, g)
    n, lq, d = theta.shape
    lk, dv = g.shape[1], g.shape[2]
    out = torch.empty((n, lq, dv), dtype=g.dtype, device=g.device)
    fn = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                 n, lq, lk, d, dv, _DTYPE_CODES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sagan_attention_fwd launch failed: cudaError {err}")
    sagan_attention.launches += 1
    return out


sagan_attention.launches = 0
