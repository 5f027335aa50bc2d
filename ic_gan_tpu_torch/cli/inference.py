"""Sampling utilities of the CLIs: the port of
``ic_gan_tpu/cli/inference.py:save_image_grid``, which the BigGAN trainer's
progress sheets use.  The rest of that module (the inference front end)
waits for ROADMAP.md A.15."""

from __future__ import annotations

import numpy as np


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> str:
    """NHWC float images in [-1, 1] → one PNG grid of ``nrow`` columns.
    Needs PIL, imported here so that the package imports without it."""
    from PIL import Image

    n, h, w, c = images.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    grid = np.clip((grid + 1) / 2, 0, 1)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
    return path
