"""PRDC: precision, recall, density and coverage (Naeem et al. 2020).

Port of ``ic_gan_tpu/eval/prdc.py`` (reference ``data_utils/
compute_pdrc.py:64-112``): the pairwise distances are one
‖a‖² + ‖b‖² − 2ab product, the k-NN radius a ``topk``, in full float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from ic_gan_tpu_torch.eval.fid import compute_device, f32, full_f32_matmul


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, shape (len(a), len(b))."""
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    with full_f32_matmul():
        d = a2 + b2.mT - 2.0 * (a @ b.mT)
    return torch.clamp(d, min=0.0)


def knn_radii(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Distance of each point to its k-th nearest neighbour within ``feats``,
    self excluded: the (k+1)-th smallest distance, self included (ref
    ``compute_pdrc.py:77-83``)."""
    d = torch.sqrt(pairwise_sq_dists(feats, feats))
    return torch.topk(d, k + 1, dim=1, largest=False).values[:, -1]


def compute_prdc(real, fake, nearest_k: int = 5, device=None) -> Dict[str, float]:
    """Precision/recall/density/coverage of ``fake`` against ``real``
    features, on ``device`` (default: the inputs' if they are tensors, else
    CUDA)."""
    device = compute_device(device, real, fake)
    real, fake = f32(real, device), f32(fake, device)
    r_rad = knn_radii(real, nearest_k)  # (Nr,)
    f_rad = knn_radii(fake, nearest_k)  # (Nf,)
    d_rf = torch.sqrt(pairwise_sq_dists(real, fake))  # (Nr, Nf)
    within_real = d_rf < r_rad[:, None]
    return {
        "precision": float(within_real.any(dim=0).float().mean()),
        "recall": float((d_rf < f_rad[None, :]).any(dim=1).float().mean()),
        "density": float(within_real.sum(dim=0).float().mean() / nearest_k),
        "coverage": float((d_rf.min(dim=1).values < r_rad).float().mean()),
    }
