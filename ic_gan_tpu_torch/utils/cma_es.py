"""CMA-ES — the colab's gradient-free z-space optimizer, in numpy.  The
port's copy of ``ic_gan_tpu/utils/cma_es.py``.

The reference notebook drives IC-GAN+CLIP guidance with
``cma.CMAEvolutionStrategy`` (``icgan_colab.ipynb``: ``cmaes.ask()`` /
``cmaes.tell(vectors, losses)``). The ``cma`` package isn't available here,
so this is the standard (μ/μ_w, λ)-CMA-ES (Hansen's tutorial formulation):
weighted recombination, cumulation paths for σ (CSA) and C (rank-1), plus
the rank-μ update. Ask/tell interface matches the notebook's usage; the
host-side linear algebra is trivial next to the generator+CLIP batch on
the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class CMAES:
    """Minimize f over R^n via ask/tell.

    ``opts`` mirrors the notebook's knobs: ``popsize``, ``seed``,
    ``AdaptSigma`` (CSA on/off), ``CMA_diagonal`` (diagonal-only C),
    ``CMA_active`` (negative-weight C update), ``bounds`` (clip asks).
    """

    def __init__(self, x0, sigma0: float, popsize: Optional[int] = None,
                 seed: Optional[int] = None, adapt_sigma: bool = True,
                 diagonal: bool = False, active: bool = True,
                 bounds=None):
        self.mean = np.asarray(x0, np.float64).copy()
        self.n = self.mean.size
        self.sigma = float(sigma0)
        self.lam = popsize or 4 + int(3 * np.log(self.n))
        self.mu = self.lam // 2
        w = np.log(self.lam / 2 + 0.5) - np.log(np.arange(1, self.lam + 1))
        self.weights = np.where(w > 0, w, 0)
        self.weights /= self.weights.sum()
        self.mueff = 1.0 / np.sum(self.weights ** 2)
        # negative weights for active CMA (normalized later)
        self.neg_weights = np.where(w < 0, w, 0)
        n, mueff = self.n, self.mueff
        self.cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
        self.cs = (mueff + 2) / (n + mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + mueff)
        self.cmu = min(1 - self.c1,
                       2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
        self.damps = 1 + 2 * max(0, np.sqrt((mueff - 1) / (n + 1)) - 1) + self.cs
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.B = np.eye(n)
        self.D = np.ones(n)
        self.adapt_sigma = adapt_sigma
        self.diagonal = diagonal
        self.active = active
        self.bounds = bounds
        self.rng = np.random.RandomState(seed)
        self.generation = 0
        self._asked: Optional[np.ndarray] = None
        self.best_x: Optional[np.ndarray] = None
        self.best_f = np.inf
        self._eig_stale = 0

    def _update_eigen(self):
        if self.diagonal:
            self.D = np.sqrt(np.maximum(np.diag(self.C), 1e-20))
            self.B = np.eye(self.n)
            return
        if self._eig_stale < max(1, int(1 / (10 * self.n * (self.c1 + self.cmu)))):
            return
        self._eig_stale = 0
        self.C = (self.C + self.C.T) / 2
        vals, vecs = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(vals, 1e-20))
        self.B = vecs

    def ask(self) -> np.ndarray:
        """(λ, n) candidate solutions."""
        self._update_eigen()
        z = self.rng.randn(self.lam, self.n)
        y = z @ (self.B * self.D).T  # B diag(D) z
        x = self.mean + self.sigma * y
        if self.bounds is not None:
            x = np.clip(x, self.bounds[0], self.bounds[1])
        self._asked = x
        return x

    def tell(self, solutions: np.ndarray, losses: List[float]):
        x = np.asarray(solutions, np.float64)
        f = np.asarray(losses, np.float64)
        order = np.argsort(f)
        x = x[order]
        if f[order[0]] < self.best_f:
            self.best_f = float(f[order[0]])
            self.best_x = x[0].copy()

        y = (x - self.mean) / self.sigma  # (λ, n) steps in x-space
        y_w = self.weights @ y  # weighted recombination of top-μ (w=0 below μ)
        old_mean = self.mean
        self.mean = self.mean + self.sigma * y_w

        # CSA path (σ control)
        if self.diagonal:
            c_inv_sqrt_y = y_w / np.maximum(np.sqrt(np.diag(self.C)), 1e-20)
        else:
            c_inv_sqrt_y = self.B @ ((self.B.T @ y_w) / self.D)
        self.ps = ((1 - self.cs) * self.ps
                   + np.sqrt(self.cs * (2 - self.cs) * self.mueff) * c_inv_sqrt_y)
        hsig = (np.linalg.norm(self.ps)
                / np.sqrt(1 - (1 - self.cs) ** (2 * (self.generation + 1)))
                < (1.4 + 2 / (self.n + 1)) * self.chi_n)

        # C paths
        self.pc = ((1 - self.cc) * self.pc
                   + hsig * np.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w)
        rank1 = np.outer(self.pc, self.pc)
        rank_mu = (y.T * self.weights) @ y
        # hsig correction rides the c1 (rank-one) term only — Hansen's
        # tutorial eq. (47): C ← (1−c1−cmu)C + c1[pc pcᵀ + (1−hsig)cc(2−cc)C]
        # + cmu·rank_mu.
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (rank1
                               + (not hsig) * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * rank_mu)
        if self.active and np.any(self.neg_weights):
            # neg_weights[i] grows in magnitude with rank i (worst members);
            # y is already sorted best-first, so apply them aligned.
            wneg = -self.neg_weights / (-self.neg_weights.sum() + 1e-20)
            self.C -= 0.5 * self.cmu * (y.T * wneg) @ y
            # keep C positive definite enough
            diag = np.diag(self.C)
            if np.any(diag <= 0):
                self.C += np.eye(self.n) * (1e-12 - min(0, diag.min()))
        self._eig_stale += 1

        if self.adapt_sigma:
            self.sigma *= np.exp(
                (self.cs / self.damps)
                * (np.linalg.norm(self.ps) / self.chi_n - 1))
            self.sigma = float(np.clip(self.sigma, 1e-12, 1e6))
        self.generation += 1

    @property
    def result(self):
        return self.best_x, self.best_f
