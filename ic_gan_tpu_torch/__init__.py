"""PyTorch/CUDA port of ``ic_gan_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the numerical reference.
Module names follow the JAX package (``ops/``, ``models/``, ``io/``) so each
counterpart is easy to find; inside, the code is plain PyTorch: ``nn.Module``s
over NCHW tensors, OIHW conv and (out, in) linear weights, ``torch.Generator``s
for randomness, and an explicit device everywhere.

The JAX package's four Pallas kernels are CUDA C++ kernels here
(``csrc/``): the SA-GAN attention forward and backward, the ADA warp's row
shift and the fused bias-activation, each built with ``nvcc`` at its first
use on the card (``ops/_build.py``).  On CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

This package imports neither ``jax`` nor ``ic_gan_tpu``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
