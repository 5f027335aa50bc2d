"""Exact k-NN over an instance-feature bank: port of ``knn`` of
``ic_gan_tpu/data/feature_bank.py`` (a faiss ``IndexFlatL2`` replacement,
reference ``data_utils/datasets_common.py:695-745``).

Brute force on the device: squared distances by blocks of queries against
the whole bank (one matmul each) and ``torch.topk``.  Plain PyTorch; no TPU
kernel backs it in the JAX package either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device


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
    bank = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    qs = bank if queries is None else torch.as_tensor(np.asarray(queries, np.float32),
                                                      device=device)
    b2 = bank.square().sum(dim=1)
    idx_blocks, d_blocks = [], []
    for lo in range(0, qs.shape[0], block):
        q = qs[lo:lo + block]
        d = q.square().sum(dim=1, keepdim=True) + b2[None, :] - 2.0 * (q @ bank.T)
        neg_d, idx = torch.topk(-d, k, dim=1)
        idx_blocks.append(idx)
        d_blocks.append(torch.clamp_min(-neg_d, 0.0))
    all_idx = torch.cat(idx_blocks).cpu().numpy().astype(np.int64)
    all_d = torch.cat(d_blocks).cpu().numpy()
    return all_idx, np.sqrt(all_d[:, -1])
