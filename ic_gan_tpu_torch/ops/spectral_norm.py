"""Spectral normalization with explicit power-iteration state.

Port of ``ic_gan_tpu/ops/spectral_norm.py`` (BigGAN's SN, reference
``BigGAN_PyTorch/layers.py:39-112``).  A weight is viewed as ``(out, -1)``:
``w.reshape(out, -1)`` on OIHW conv and (out, in) linear weights.  The JAX
package flattens HWIO as (out, kh·kw·in) instead; σ does not depend on the
column order and ``u`` lives in the out-dimensional space, so the state
``u`` (num_svs, out) carries over between the two unchanged.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


@torch.no_grad()
def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, num_itrs: int = 1,
                    eps: float = 1e-6):
    """``num_itrs`` power-iteration steps on ``w_mat`` (out, in_flat) from the
    estimates ``u`` (num_svs, out).  Returns ``(svs, new_u, vs)``: singular
    values (num_svs,), the advanced state and the right vectors."""
    num_svs = u.shape[0]
    vs = []
    for _ in range(num_itrs):
        us, vs = [], []
        for i in range(num_svs):
            v = u[i] @ w_mat
            # Gram-Schmidt against previously-extracted right vectors.
            for v_prev in vs:
                v = v - (v @ v_prev) / (v_prev @ v_prev) * v_prev
            v = _l2_normalize(v, eps)
            vs.append(v)
            u_new = v @ w_mat.T
            for u_prev in us:
                u_new = u_new - (u_new @ u_prev) / (u_prev @ u_prev) * u_prev
            u_new = _l2_normalize(u_new, eps)
            us.append(u_new)
        u = torch.stack(us)
    vs_arr = torch.stack(vs)
    # σ_i = v_i @ Wᵀ @ u_iᵀ
    svs = torch.einsum("si,oi,so->s", vs_arr, w_mat, u)
    return svs, u, vs_arr


@torch.no_grad()
def spectral_normalize(w: torch.Tensor, u: torch.Tensor, update: bool = False,
                       num_itrs: int = 1, eps: float = 1e-6):
    """``(w / σ, new_u, svs)`` for a weight whose leading axis is ``out``.

    With ``update=False`` (eval) the returned state is the input ``u``, but σ
    is still recomputed from it, as the reference does at eval."""
    w_mat = w.reshape(w.shape[0], -1)
    svs, new_u, _ = power_iteration(w_mat, u, num_itrs=num_itrs, eps=eps)
    if not update:
        new_u = u
    return w / svs[0], new_u, svs
