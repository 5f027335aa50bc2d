"""The host-side data of a train cell, from the seed, as a training loop's
dataset would hand it over: a pool of uint8 images, a bank of unit-norm
instance features (row i is image i's), and the rows each step takes, the
real rows of the first pass all distinct."""

from __future__ import annotations

import numpy as np
import torch

from weights import sub_seed


class Feed:
    def __init__(self, seed: int, pool_key: int, cond_key: int, *, images: int,
                 channels: int, resolution: int, feat_dim: int, bank_rows: int,
                 microbatch: int, gen_shape: tuple):
        rng = np.random.default_rng(sub_seed(seed, pool_key))
        self.pool = rng.integers(0, 256, (images, channels, resolution, resolution),
                                 dtype=np.uint8)
        bank = rng.standard_normal((max(bank_rows, images), feat_dim), dtype=np.float32)
        self.bank = bank / np.linalg.norm(bank, axis=1, keepdims=True)
        self.cond_seed = sub_seed(seed, cond_key)
        self.order = np.concatenate([rng.permutation(images) for _ in range(16)])
        self.mb, self.gen_shape = microbatch, gen_shape

    def rows(self, step: int) -> tuple:
        """Step ``step``'s real rows and generator-conditioning rows."""
        at = (step * self.mb) % (len(self.order) - self.mb)
        gen = np.random.default_rng([self.cond_seed, step])
        return self.order[at:at + self.mb], gen.integers(0, len(self.bank), self.gen_shape)

    def images(self, rows, device) -> torch.Tensor:
        """The rows through the port's loader (``data/loader.py``)."""
        from ic_gan_tpu_torch.data.loader import normalize_batch

        return normalize_batch(self.pool[rows], device=device)

    def reference_images(self, rows, device) -> torch.Tensor:
        """The same rows by the loader's formula, float(x)·(2/255) − 1, in
        float32, for the reference."""
        return torch.as_tensor(self.pool[rows]).to(device).float() * np.float32(2.0 / 255.0) \
            - 1.0

    def features(self, rows, device) -> torch.Tensor:
        return torch.as_tensor(self.bank[rows]).to(device)
