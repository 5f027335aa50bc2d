"""FID, Inception Score and feature moments.

Port of ``ic_gan_tpu/eval/fid.py`` (reference ``data_utils/
inception_utils.py:42-479``): moments accumulate on the host in float64, or
on the device in float32 for the one-call metric tail (``fid_is_device``);
the matrix square root is the coupled Newton-Schulz iteration (the
reference's GPU trick, ``inception_utils.py:144-186``), with an exact
symmetric-eigenvalue path for the rank-deficient covariances on which it
goes non-finite.

Every float32 product here runs in full float32, whatever the caller set
(``full_f32_matmul``): TF32 inside a 50-step iteration moves FID.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compute_device(device=None, *arrays) -> torch.device:
    """``device``; else the device of the first tensor in ``arrays``; else
    CUDA (``resolve_device``)."""
    if device is None:
        device = next((a.device for a in arrays if torch.is_tensor(a)), None)
    return resolve_device(device)


def f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matrix products in full float32 (no TF32, no bf16 passes)
    inside the block; the caller's settings back after it, exactly.

    PyTorch keeps a generic precision and one for each backend's matmul,
    and refuses to read the generic one once they disagree (one set by the
    legacy ``allow_tf32`` flags, another by the new API).  So the block
    reads and restores each backend's own setting, and moves the generic
    one only where it can be read."""
    cuda, mkldnn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    prev_cuda, prev_mkldnn = cuda.fp32_precision, mkldnn.fp32_precision
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:  # the settings disagree: leave the generic one alone
        prev = None
    if prev is not None:
        torch.set_float32_matmul_precision("highest")
    cuda.fp32_precision = mkldnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        if prev is not None:
            torch.set_float32_matmul_precision(prev)
        cuda.fp32_precision, mkldnn.fp32_precision = prev_cuda, prev_mkldnn


@contextlib.contextmanager
def full_f32():
    """``full_f32_matmul``, and cuDNN's float32 convolutions in full float32
    too (no TF32) inside the block; the convolutions' own setting back
    after it.  PPL differences images ε = 1e-4 apart and divides by ε²,
    where TF32's rounding of the activations would be all it measured (the
    reference turns TF32 off for its metrics, ``calc_metrics.py``)."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        with full_f32_matmul():
            yield
    finally:
        conv.fp32_precision = prev


class FeatureMoments:
    """Streaming mean/covariance accumulator in float64 on the host (the
    reference's ``np.mean``/``np.cov``, ``inception_utils.py:289-341``)."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        f = np.asarray(to_host(feats), np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    @property
    def mean(self) -> np.ndarray:
        return self.sum / self.n

    @property
    def cov(self) -> np.ndarray:
        mu = self.mean
        # Unbiased covariance (np.cov's default, as the reference uses).
        return (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mean, sigma=self.cov)


# Newton-Schulz iterations (the reference's and the JAX package's count).
NS_ITERS = 50


def sqrtm_newton_schulz(mat: torch.Tensor) -> torch.Tensor:
    """Matrix square root by the coupled Newton-Schulz iteration (ref
    ``inception_utils.py:144-186``), ``NS_ITERS`` iterations in ``mat``'s
    dtype and on its device, with no host sync.  Not finite on a
    rank-deficient product (fewer samples than features)."""
    with full_f32_matmul():
        norm = torch.sqrt(torch.sum(mat * mat))
        y = mat / norm
        eye = torch.eye(mat.shape[0], dtype=mat.dtype, device=mat.device)
        z = eye
        for _ in range(NS_ITERS):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
        return y * torch.sqrt(norm)


def _tr_sqrtm_psd_pair(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """tr √(s1·s2) for PSD s1, s2, exactly: λ(s1·s2) = λ(√s1·s2·√s1) ≥ 0, so
    the trace is Σᵢ√λᵢ of a symmetric eigenproblem.  Inputs symmetrized, as
    ``jnp.linalg.eigh`` does."""
    with full_f32_matmul():
        w1, v1 = torch.linalg.eigh((s1 + s1.mT) / 2)
        sqrt_s1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.mT
        m = sqrt_s1 @ s2 @ sqrt_s1
        w = torch.linalg.eigvalsh((m + m.mT) / 2)
        return torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))


def trace_sqrtm_product(s1: torch.Tensor, s2: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(tr √(s1·s2), whether the eigenvalue path gave it): Newton-Schulz, and
    the exact path exactly when its trace is not finite (rank-deficient
    covariances: few samples in a high dimension).  Reading the trace's
    finiteness is the one host sync of the FID tail."""
    with full_f32_matmul():
        tr = torch.trace(sqrtm_newton_schulz(s1 @ s2))
    if bool(torch.isfinite(tr)):
        return tr, False
    return _tr_sqrtm_psd_pair(s1, s2), True


def frechet_distance(mu1, sigma1, mu2, sigma2, device=None) -> float:
    """FID between two Gaussians (ref ``torch_calculate_frechet_distance``,
    ``inception_utils.py:189-232``), in float32 on ``device`` (default: the
    inputs' if they are tensors, else CUDA)."""
    device = compute_device(device, mu1, sigma1, mu2, sigma2)
    mu1, mu2, s1, s2 = (f32(a, device) for a in (mu1, mu2, sigma1, sigma2))
    diff = mu1 - mu2
    tr_covmean, _ = trace_sqrtm_product(s1, s2)
    return float(diff @ diff + torch.trace(s1) + torch.trace(s2) - 2.0 * tr_covmean)


def inception_score(logits_or_probs, num_splits: int = 10, from_logits: bool = True
                    ) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) ‖ p(y))) over ``num_splits`` chunks, in float64
    on the host (ref ``calculate_inception_score``, ``inception_utils.py:
    269-283``)."""
    x = np.asarray(to_host(logits_or_probs), np.float64)
    if from_logits:
        x = x - x.max(axis=1, keepdims=True)
        e = np.exp(x)
        probs = e / e.sum(axis=1, keepdims=True)
    else:
        probs = x
    scores = []
    n = probs.shape[0]
    num_splits = max(1, min(num_splits, n))  # no empty splits on tiny n
    for i in range(num_splits):
        part = probs[i * n // num_splits: (i + 1) * n // num_splits]
        py = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-10) - np.log(py + 1e-10)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score_device(logits: torch.Tensor, num_splits: int = 10):
    """IS over logits left on their device, in float32: (mean, std) as
    0-dim tensors there."""
    probs = torch.softmax(logits.float(), dim=1)
    n = probs.shape[0]
    ns = max(1, min(num_splits, n))
    scores = []
    for i in range(ns):
        part = probs[i * n // ns: (i + 1) * n // ns]
        py = part.mean(dim=0, keepdim=True)
        kl = torch.sum(part * (torch.log(part + 1e-10) - torch.log(py + 1e-10)), dim=1)
        scores.append(torch.exp(kl.mean()))
    s = torch.stack(scores)
    return s.mean(), s.std(correction=0)


def compute_fid_from_moments(fake: FeatureMoments, ref_mu, ref_sigma,
                             device=None) -> float:
    return frechet_distance(fake.mean, fake.cov, ref_mu, ref_sigma, device=device)


def fid_is_device(pool: torch.Tensor, logits: torch.Tensor, ref_mu, ref_sigma,
                  num_splits: int = 10):
    """The eval's metric tail on the features' device: pool features →
    (mu, sigma) in float32 → FID against the reference moments, and IS over
    the logits.  Returns (fid, is_mean, is_std) as 0-dim tensors there; the
    Newton-Schulz trace's finiteness is read on the host once."""
    p = pool.float()
    with full_f32_matmul():
        mu = p.mean(dim=0)
        d0 = p - mu
        sigma = d0.mT @ d0 / (p.shape[0] - 1)
        mu2, s2 = f32(ref_mu, p.device), f32(ref_sigma, p.device)
        diff = mu - mu2
        tr, _ = trace_sqrtm_product(sigma, s2)
        fid = diff @ diff + torch.trace(sigma) + torch.trace(s2) - 2.0 * tr
    is_mean, is_std = inception_score_device(logits, num_splits)
    return fid, is_mean, is_std
