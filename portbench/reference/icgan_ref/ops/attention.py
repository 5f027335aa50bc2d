"""SA-GAN attention, o = softmax(θ·φᵀ)·g, in plain PyTorch: the port's
plain version, differentiated by autograd (no kernel)."""

from __future__ import annotations

import torch


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


def sagan_attention(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(θ·φᵀ)·g, differentiable by autograd."""
    return sagan_attention_ref(theta, phi, g)
