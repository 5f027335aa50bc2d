"""A frozen copy of the port's plain paths: the plain reference of the benchmark.

The BigGAN and StyleGAN2 models, their train steps, the ADA pipe and what
they call, copied from the PyTorch port as the benchmark was written, with
the three CUDA kernels (SA-GAN attention, bias-activation, row shift)
replaced by their plain PyTorch versions, and cut to the single-process
float paths that the cells drive (no int8 serving, no data mesh, no
DiffAugment).  It imports nothing of the port,
so a later change to the port cannot change what the port is judged
against.  Run it in float32 with TF32 off.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu'")
    return device
