"""SA-GAN attention, o = softmax(θ·φᵀ)·g, in the JAX package's (N, L, d)
layout, with its first-order gradient.

``sagan_attention`` is ``SAGANAttention.apply``, the counterpart of the JAX
package's ``custom_vjp`` (``ic_gan_tpu/ops/pallas/attention.py:182-216``),
wherever a gradient is wanted; at inference it calls the forward as the
``torch.library`` op ``ic_gan_tpu::sagan_attention_fwd``, which
``torch.export`` keeps in a program (``io/deploy.py:export_sampler``).
On CUDA tensors its forward launches ``csrc/sagan_attention_fwd.cu`` (the
port of ``_attn_kernel``) and its backward ``csrc/sagan_attention_bwd.cu``
(the port of ``_attn_bwd_kernel``); on CPU tensors they run their plain
PyTorch versions, ``sagan_attention_ref`` and ``sagan_attention_bwd_ref``.
Both kernels dispatch on the dtype: bf16 runs on the tensor cores
(Hopper's warpgroup MMA, ``wgmma``), f32 on the CUDA cores in full f32.  The
forward hands its per-row log-sum-exp to the backward.  Unscaled,
non-causal.  Each launch adds one to ``sagan_attention_fwd.launches`` or
``sagan_attention_bwd.launches``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ic_gan_tpu_torch.ops import _build

MAX_D = 128
MAX_DV = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sagan_attention_ref(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                        return_lse: bool = False):
    """Plain version, as ``_attention_xla``: f32 logits and softmax, p cast
    to g's type, second product accumulated in f32, output in g's type.
    With ``return_lse`` also each row's f32 log-sum-exp of the logits,
    (N, Lq): the statistics the backward takes."""
    logits = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p.to(g.dtype).float(), g.float()).to(g.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def sagan_attention_bwd_ref(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                            do: torch.Tensor, lse=None, o=None):
    """Plain backward, the explicit formula of ``_sagan_bwd``
    (``attention.py:202-213``): p in f32, dp = do·gᵀ, ds = p⊙(dp − delta),
    dθ = ds·φ, dφ = dsᵀ·θ, dg = pᵀ·do, all in f32, each returned in its
    input's type.

    Without ``lse``, p is the softmax of the logits and delta = rowsum(dp⊙p).
    Given the forward's saved state, p = exp(logits − lse) with ``lse`` the
    (N, Lq) f32 log-sum-exp, and delta = rowsum(dp⊙p), or rowsum(do⊙o) when
    the forward's output ``o`` is given too: equal in exact arithmetic.  The
    kernel takes ``lse`` alone; the bf16 ``o`` is rounded too coarsely for
    delta (``csrc/sagan_attention_bwd.cu``)."""
    logits = torch.matmul(theta.float(), phi.float().transpose(1, 2))
    if lse is None:
        p = torch.softmax(logits, dim=-1)
    else:
        p = torch.exp(logits - lse.float().unsqueeze(-1))
    del logits
    do32 = do.float()
    dp = torch.matmul(do32, g.float().transpose(1, 2))
    if o is None:
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    del dp
    dg = torch.matmul(p.transpose(1, 2), do32)
    del p
    dtheta = torch.matmul(ds, phi.float())
    dphi = torch.matmul(ds.transpose(1, 2), theta.float())
    return dtheta.to(theta.dtype), dphi.to(phi.dtype), dg.to(g.dtype)


def _check(*ts):
    """Raise on what the kernels do not take: (theta, phi, g) or (theta, phi,
    g, do)."""
    names = ", ".join(("theta", "phi", "g", "do")[:len(ts)])
    theta, phi, g = ts[:3]
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{names} must lie on one device, got "
                         + ", ".join(str(t.device) for t in ts))
    if theta.device.type != "cuda":
        raise ValueError(f"sagan_attention runs on CPU or CUDA, not {theta.device}")
    if len({t.dtype for t in ts}) != 1 or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"{names} must share one dtype of float32 or bfloat16, got "
                         + ", ".join(str(t.dtype) for t in ts))
    if any(t.dim() != 3 for t in ts):
        raise ValueError("theta, phi and g must be (N, L, d) tensors")
    n, lq, d = theta.shape
    if phi.shape[0] != n or g.shape[0] != n or phi.shape[2] != d \
            or g.shape[1] != phi.shape[1]:
        raise ValueError(f"shapes do not fit: theta {tuple(theta.shape)}, "
                         f"phi {tuple(phi.shape)}, g {tuple(g.shape)}")
    if len(ts) == 4 and tuple(ts[3].shape) != (n, lq, g.shape[2]):
        raise ValueError(f"do must be {(n, lq, g.shape[2])}, got {tuple(ts[3].shape)}")
    if not (0 < d <= MAX_D and 0 < g.shape[2] <= MAX_DV):
        raise ValueError(f"the kernel takes d <= {MAX_D} and dv <= {MAX_DV}, "
                         f"got d {d}, dv {g.shape[2]}")
    if not (0 < n <= 65535 and theta.shape[1] > 0 and phi.shape[1] > 0):
        raise ValueError(f"the kernel takes 0 < N <= 65535 and non-empty "
                         f"sequences, got {tuple(theta.shape)}, {tuple(phi.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{names} must be contiguous")


def _check_lse(lse, theta):
    n, lq = theta.shape[:2]
    if lse.device != theta.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (n, lq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(n, lq)} tensor on "
                         f"{theta.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _entry(name: str, n_ptrs: int):
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def sagan_attention_fwd(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                        return_lse: bool = False):
    """softmax(θ·φᵀ)·g.  θ (N, Lq, d), φ (N, Lk, d), g (N, Lk, dv) →
    (N, Lq, dv) in g's type; with ``return_lse`` also the (N, Lq) f32
    log-sum-exp of the logits.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (bf16 on the tensor
    cores, f32 on the CUDA cores), or raise."""
    if _on_cpu(theta, phi, g):
        return sagan_attention_ref(theta, phi, g, return_lse=return_lse)
    _check(theta, phi, g)
    n, lq, d = theta.shape
    lk, dv = g.shape[1], g.shape[2]
    out = torch.empty((n, lq, dv), dtype=g.dtype, device=g.device)
    lse = torch.empty((n, lq), dtype=torch.float32, device=g.device) if return_lse else None
    fn = _entry("sagan_attention_fwd", 5)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 n, lq, lk, d, dv, _DTYPE_CODES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sagan_attention_fwd launch failed: cudaError {err}")
    sagan_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def sagan_attention_bwd(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor):
    """(dθ, dφ, dg) of softmax(θ·φᵀ)·g for the output gradient ``do``
    (N, Lq, dv), given the forward's (N, Lq) f32 log-sum-exp ``lse``; each
    gradient in its input's type.  CPU tensors take the plain version; CUDA
    tensors launch the kernel's two passes on the current stream (bf16 on
    the tensor cores, f32 on the CUDA cores), or raise."""
    if _on_cpu(theta, phi, g, do, lse):
        return sagan_attention_bwd_ref(theta, phi, g, do, lse=lse)
    _check(theta, phi, g, do)
    _check_lse(lse, theta)
    n, lq, d = theta.shape
    lk, dv = g.shape[1], g.shape[2]
    dtheta, dphi, dg = torch.empty_like(theta), torch.empty_like(phi), torch.empty_like(g)
    # Per-row delta = rowsum(dp⊙p), handed from the q-tile pass to the k-tile pass.
    delta = torch.empty((n, lq), dtype=torch.float32, device=g.device)
    fn = _entry("sagan_attention_bwd", 9)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dtheta.data_ptr(), dphi.data_ptr(), dg.data_ptr(),
                 delta.data_ptr(), n, lq, lk, d, dv, _DTYPE_CODES[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sagan_attention_bwd launch failed: cudaError {err}")
    sagan_attention_bwd.launches += 1
    return dtheta, dphi, dg


sagan_attention_fwd.launches = 0
sagan_attention_bwd.launches = 0


class SAGANAttention(torch.autograd.Function):
    """softmax(θ·φᵀ)·g with the kernel pair as forward and backward; saves
    θ, φ and g, the JAX residuals (``attention.py:192-193``), and the
    forward's log-sum-exp, so the backward needs no statistics sweep.  First
    order only, as in the JAX package."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        if not any(ctx.needs_input_grad):  # inference: no statistics to keep
            return sagan_attention_fwd(theta, phi, g)
        out, lse = sagan_attention_fwd(theta, phi, g, return_lse=True)
        ctx.save_for_backward(theta, phi, g, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        theta, phi, g, lse = ctx.saved_tensors
        return sagan_attention_bwd(theta, phi, g, do.contiguous(), lse)


@torch.library.custom_op("ic_gan_tpu::sagan_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _attention_op(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The forward as a ``torch.library`` op, so that ``torch.export`` keeps
    it in a program (a ctypes launch cannot be traced): on CUDA the kernel
    launch, counted as every launch is."""
    return sagan_attention_fwd(theta, phi, g)


@_attention_op.register_kernel("cpu")
def _(theta, phi, g):
    return sagan_attention_ref(theta, phi, g)


@_attention_op.register_fake
def _(theta, phi, g):
    return g.new_empty((theta.shape[0], theta.shape[1], g.shape[2]))


def sagan_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(θ·φᵀ)·g.  Where a gradient is wanted, ``SAGANAttention``;
    at inference the op ``torch.ops.ic_gan_tpu.sagan_attention_fwd``, the
    same forward, which an exported program keeps."""
    if torch.is_grad_enabled() and (theta.requires_grad or phi.requires_grad
                                    or g.requires_grad):
        return SAGANAttention.apply(theta, phi, g)
    if len({theta.device, phi.device, g.device}) != 1 or theta.device.type not in ("cpu", "cuda"):
        raise ValueError("sagan_attention runs on CPU or CUDA tensors on one device, got "
                         f"{theta.device}, {phi.device}, {g.device}")
    return torch.ops.ic_gan_tpu.sagan_attention_fwd(theta, phi, g)
