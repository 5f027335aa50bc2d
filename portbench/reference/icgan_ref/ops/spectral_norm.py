"""Spectral normalization with explicit power-iteration state.

Port of ``ic_gan_tpu/ops/spectral_norm.py`` (BigGAN's SN, reference
``BigGAN_PyTorch/layers.py:39-112``).  A weight is viewed as ``(out, -1)``:
``w.reshape(out, -1)`` on OIHW conv and (out, in) linear weights.  The JAX
package flattens HWIO as (out, kh·kw·in) instead; σ does not depend on the
column order and ``u`` lives in the out-dimensional space, so the state
``u`` (num_svs, out) carries over between the two unchanged.

Gradients flow through ``W`` in both the numerator and σ: the power
iteration runs under ``no_grad`` on a detached ``W``, so ``u`` and ``v`` are
constants, and σ = v·Wᵀ·uᵀ is then taken on the autograd tape, as the JAX
package's ``stop_gradient``s and the reference do.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, num_itrs: int = 1,
                    eps: float = 1e-6):
    """``num_itrs`` power-iteration steps on ``w_mat`` (out, in_flat) from the
    estimates ``u`` (num_svs, out).  Returns ``(svs, new_u, vs)``: singular
    values (num_svs,), differentiable with respect to ``w_mat``; the advanced
    state and the right vectors, both constants (fresh tensors, so that a
    caller may copy ``new_u`` into its buffer after σ has been saved for
    backward)."""
    num_svs = u.shape[0]
    vs = []
    with torch.no_grad():
        w_ng = w_mat.detach()
        for _ in range(num_itrs):
            us, vs = [], []
            for i in range(num_svs):
                v = u[i] @ w_ng
                # Gram-Schmidt against previously-extracted right vectors.
                for v_prev in vs:
                    v = v - (v @ v_prev) / (v_prev @ v_prev) * v_prev
                v = _l2_normalize(v, eps)
                vs.append(v)
                u_new = v @ w_ng.T
                for u_prev in us:
                    u_new = u_new - (u_new @ u_prev) / (u_prev @ u_prev) * u_prev
                u_new = _l2_normalize(u_new, eps)
                us.append(u_new)
            u = torch.stack(us)
        vs_arr = torch.stack(vs)
    # σ_i = v_i @ Wᵀ @ u_iᵀ, on the tape through W only.
    svs = torch.einsum("si,oi,so->s", vs_arr, w_mat, u)
    return svs, u, vs_arr


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, update: bool = False,
                       num_itrs: int = 1, eps: float = 1e-6):
    """``(w / σ, new_u, svs)`` for a weight whose leading axis is ``out``.

    ``w / σ`` differentiates through ``w``; ``new_u`` and ``svs`` are
    detached.  With ``update=False`` (eval) the returned state is the input
    ``u``, but σ is still recomputed from it, as the reference does at eval.
    With ``update=True`` it is the advanced state, a new tensor."""
    w_mat = w.reshape(w.shape[0], -1)
    svs, new_u, _ = power_iteration(w_mat, u, num_itrs=num_itrs, eps=eps)
    if not update:
        new_u = u
    return w / svs[0], new_u, svs.detach()
