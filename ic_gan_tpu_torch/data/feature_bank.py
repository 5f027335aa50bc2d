"""Instance-feature bank: exact k-NN and k-means on the device, a port of
``ic_gan_tpu/data/feature_bank.py`` (faiss replacements: ``IndexFlatL2``
exact k-NN over N×2048 features, reference
``data_utils/datasets_common.py:695-745``, and ``faiss.Kmeans`` with 100
Lloyd iterations for the 1000-instance selection,
``data_utils/store_kmeans_indexes.py:15-133``).

Both are brute force: squared distances by one matmul per block
(q² + b² − 2·q·b), then ``torch.topk`` for the k-NN and ``argmin`` plus a
segment sum (``index_add_``) for a Lloyd step.  No TPU kernel backs them in
the JAX package either.  The products run in full float32 whatever the
caller set (``eval.fid.full_f32_matmul``): for unit vectors the distance
formula cancels down to differences of order 1e-3, where TF32's 10-bit
mantissa would reorder neighbours.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.eval.fid import full_f32_matmul


def _rows(feats, device, normalize: bool) -> torch.Tensor:
    """float32 rows on ``device``; with ``normalize`` L2-normalized first, on
    the host as the JAX package does (norms floored at 1e-12)."""
    f = np.asarray(feats, np.float32)
    if normalize:
        f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    return torch.as_tensor(f, device=device)


def _sq_dists(q: torch.Tensor, b: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (Q, B) of rows of ``q`` to rows of ``b``
    (``b2`` the squared norms of ``b``)."""
    return q.square().sum(dim=1, keepdim=True) + b2[None, :] - 2.0 * (q @ b.T)


def _knn_block(queries: torch.Tensor, bank: torch.Tensor, k: int, b2=None):
    """Exact k nearest neighbours of ``queries`` within ``bank`` (squared L2,
    like IndexFlatL2): (distances² clamped at 0, indices), each (Q, k)."""
    b2 = bank.square().sum(dim=1) if b2 is None else b2
    neg_d, idx = torch.topk(-_sq_dists(queries, bank, b2), k, dim=1)
    return torch.clamp_min(-neg_d, 0.0), idx


def knn(feats, k: int = 50, queries=None, block: int = 4096,
        device=None) -> Tuple[np.ndarray, np.ndarray]:
    """k-NN table for the whole bank (ref ``_obtain_nns``: each point is its
    own first neighbour, ``datasets_common.py:719-738``), computed on
    ``device`` (CUDA unless named).

    Returns (neighbour indices (N, k) int64, radii (N,) float32), ``radii``
    the distance to the k-th neighbour (ref ``make_hdf5_nns.py`` stores it
    as ``sample_nns_radius``).
    """
    device = resolve_device(device)
    bank = _rows(feats, device, normalize=False)
    qs = bank if queries is None else _rows(queries, device, normalize=False)
    idx_blocks, d_blocks = [], []
    with full_f32_matmul():
        b2 = bank.square().sum(dim=1)
        for lo in range(0, qs.shape[0], block):
            d, idx = _knn_block(qs[lo:lo + block], bank, k, b2)
            idx_blocks.append(idx)
            d_blocks.append(d)
    all_idx = torch.cat(idx_blocks).cpu().numpy().astype(np.int64)
    all_d = torch.cat(d_blocks).cpu().numpy()
    return all_idx, np.sqrt(all_d[:, -1])


def _lloyd_step(feats: torch.Tensor, centroids: torch.Tensor, num_clusters: int,
                block: int = 16384):
    """One Lloyd iteration: assign every row to its nearest centroid (the
    first on a tie, as ``jnp.argmin``), then move each centroid to the mean
    of its rows (an empty cluster keeps its centroid).  The distances go by
    blocks of ``block`` rows.  Returns (new centroids, assignments)."""
    c2 = centroids.square().sum(dim=1)
    assign = torch.cat([torch.argmin(_sq_dists(feats[lo:lo + block], centroids, c2), dim=1)
                        for lo in range(0, feats.shape[0], block)])
    sums = torch.zeros_like(centroids).index_add_(0, assign, feats)
    counts = torch.zeros(num_clusters, dtype=feats.dtype, device=feats.device).index_add_(
        0, assign, torch.ones_like(feats[:, 0]))
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centroids)
    return new, assign


def kmeans(feats, num_clusters: int = 1000, num_iters: int = 100, seed: int = 0,
           normalize: bool = True, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means (faiss ``Kmeans(niter=100)`` equivalent,
    ``store_kmeans_indexes.py:47-62``) on ``device`` (CUDA unless named).
    Features are L2-normalized first, as the reference does
    (``store_kmeans_indexes.py:47-50``); the initial centroids are the rows
    ``np.random.RandomState(seed).choice(N, K, replace=False)``, the JAX
    package's.

    Returns (centroids (K, D), assignments (N,)) as numpy arrays.
    """
    device = resolve_device(device)
    f = _rows(feats, device, normalize)
    init_idx = np.random.RandomState(seed).choice(f.shape[0], num_clusters, replace=False)
    centroids = f[torch.as_tensor(init_idx, device=device)]
    assign = None
    with full_f32_matmul():
        for _ in range(num_iters):
            centroids, assign = _lloyd_step(f, centroids, num_clusters)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def closest_real_to_centroids(feats, centroids, normalize: bool = True,
                              device=None) -> np.ndarray:
    """Index of the closest real sample to each centroid (ref
    ``store_kmeans_indexes.py:63-79``: the released 1000-instance
    conditioning sets are built this way), on ``device`` (CUDA unless
    named)."""
    device = resolve_device(device)
    f = _rows(feats, device, normalize)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=device)
    with full_f32_matmul():
        _, idx = _knn_block(c, f, 1)
    return idx[:, 0].cpu().numpy().astype(np.int64)
