"""VGG16 and the LPIPS perceptual distance in PyTorch (NCHW): port of
``ic_gan_tpu/models/vgg.py``.

The reference's PPL metric and projector score images with NVIDIA's
``vgg16.pt`` torchscript, a VGG16 trunk with the Zhang et al. LPIPS head
(``stylegan2_ada_pytorch/metrics/perceptual_path_length.py:112-116``,
``projector.py:68-76``): images arrive in [0, 255], and
``return_lpips=True`` yields a feature vector whose squared L2 difference is
the LPIPS distance.  This module implements that contract:

- ``VGG16``: the 13-conv torchvision ``features`` trunk under torchvision's
  names (``features.{i}.weight``, OIHW), so a torchvision state dict loads
  as it is, and the five LPIPS channel weights ``lin_{0-4}``.
- The LPIPS head: unit-normalize the five ReLU taps (relu1_2/2_2/3_3/4_3/
  5_3) over channels, weight the channels by the learned ``lin`` 1×1 convs
  (clamped at 0, as richzhang's eval does), average over the plane, sum the
  layers (Zhang et al. 2018, eq. 1).
- ``lpips_features`` folds √lin/√(H·W) into the normalized taps, so that
  ``sum((f0 − f1)²)`` is the distance.  Each tap is flattened in the JAX
  package's (H, W, C) order, so the vectors themselves equal its vectors,
  not only their distances.

Weights: torchvision ``vgg16`` state dicts, richzhang ``lpips``
checkpoints or NVIDIA's ``vgg16.pt`` torchscript, through
``load_vgg16_file``; without a file the net runs with random weights from a
seed, self-consistent but not comparable with published numbers.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.eval.fid import full_f32

# torchvision vgg16.features: (index, out channels) of the 13 convs, each
# followed by a ReLU at index + 1; a 2×2/2 max pool before each block.
_CONV_PLAN: Tuple[Tuple[int, int], ...] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
)
# Convs whose ReLU output feeds the LPIPS head (relu1_2, relu2_2, relu3_3,
# relu4_3, relu5_3).
_TAP_AFTER = (2, 7, 14, 21, 28)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
_POOL_BEFORE = (5, 10, 17, 24)

# Zhang et al.'s ScalingLayer constants (input in [-1, 1]).
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16(nn.Module):
    """Eval-mode VGG16 trunk with the LPIPS head, float32 on ``device``
    (default CUDA).  Random weights, drawn from ``generator``: He-normal
    convs (std √(2/fan_in), which keeps the activations' scale through the
    ReLUs), zero biases, ``lin`` ones (uniform channel weights).

    ``forward`` is the NVIDIA torchscript's contract: (B, 3, H, W) float
    images in [0, 255] → the LPIPS feature vector (B, D).  ``extract`` gives
    the raw ReLU taps, ``lpips_distance`` the pairwise distances without the
    feature vectors."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        layers, cin = [], 3
        for idx, ch in _CONV_PLAN:
            if idx in _POOL_BEFORE:
                layers.append(nn.MaxPool2d(2, 2))
            layers += [nn.Conv2d(cin, ch, 3, padding=1, device=device), nn.ReLU()]
            cin = ch
        layers.append(nn.MaxPool2d(2, 2))       # torchvision's index 30
        self.features = nn.Sequential(*layers)
        for i, ch in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin_{i}", nn.Parameter(torch.ones(ch, device=device)))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT, device=device),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE, device=device),
                             persistent=False)
        with torch.no_grad():
            for idx, _ in _CONV_PLAN:
                conv = self.features[idx]
                w = torch.empty(conv.weight.shape).normal_(
                    0.0, (2.0 / conv.weight[0].numel()) ** 0.5, generator=generator)
                conv.weight.copy_(w)
                conv.bias.zero_()
        self.eval().requires_grad_(False)

    def _taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        # [0, 255] → [-1, 1] → Zhang's scaling (what lpips.LPIPS does for
        # 255-range input; NVIDIA's script reproduces richzhang's numerics).
        x = x / 127.5 - 1.0
        x = (x - self.shift[:, None, None]) / self.scale[:, None, None]
        taps = []
        for idx, _ in _CONV_PLAN:
            if idx in _POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(self.features[idx](x))
            if idx in _TAP_AFTER:
                taps.append(x)
        return taps

    def _lin(self, i: int) -> torch.Tensor:
        # richzhang clamps the lin weights at 0 in eval.
        return F.relu(getattr(self, f"lin_{i}"))

    @staticmethod
    def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
        return f * torch.rsqrt(f.square().sum(dim=1, keepdim=True) + 1e-10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lpips_features(x)

    def lpips_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 255] → (B, D) with ‖f0 − f1‖² = LPIPS; each
        tap flattened in (H, W, C) order."""
        out = []
        for i, f in enumerate(self._taps(x)):
            h, w = f.shape[2], f.shape[3]
            f = self._unit_normalize(f) * torch.sqrt(self._lin(i) / (h * w))[:, None, None]
            out.append(f.permute(0, 2, 3, 1).reshape(f.shape[0], -1))
        return torch.cat(out, dim=1)

    def extract(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The raw ReLU taps (for feature-matching losses), NCHW."""
        return self._taps(x)

    def lpips_distance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """LPIPS between two [0, 255] NCHW batches, pair by pair → (B,)."""
        d = 0.0
        for i, (fx, fy) in enumerate(zip(self._taps(x), self._taps(y))):
            diff = (self._unit_normalize(fx) - self._unit_normalize(fy)).square()
            d = d + (diff * self._lin(i)[:, None, None]).sum(dim=1).mean(dim=(1, 2))
        return d


# --------------------------------------------------------------------------
# Weight conversion: each loader returns the port's state dict (float32 CPU
# tensors, ``features.{i}.{weight,bias}`` and ``lin_{0-4}``).


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


def load_torchvision_vgg16(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict (tensors or numpy arrays) → the
    port's: the 13 convs as they are, the classifier dropped (LPIPS never
    runs it), ``lin_*`` ones unless merged from a LPIPS checkpoint by
    ``load_lpips_linear``."""
    sd = {}
    for idx, ch in _CONV_PLAN:
        w = _t(state_dict[f"features.{idx}.weight"])
        if w.shape[0] != ch:
            raise ValueError(f"features.{idx}.weight: shape {tuple(w.shape)}, want {ch} outputs")
        sd[f"features.{idx}.weight"] = w
        sd[f"features.{idx}.bias"] = _t(state_dict[f"features.{idx}.bias"])
    for i, ch in enumerate(_TAP_CHANNELS):
        sd[f"lin_{i}"] = torch.ones(ch)
    return sd


def load_lpips_linear(state_dict: Dict, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``params`` with richzhang LPIPS ``lin{i}.model.1.weight`` (1, C, 1, 1)
    channel weights merged in (a new dict)."""
    params = dict(params)
    for i, ch in enumerate(_TAP_CHANNELS):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight", f"lin{i}.weight"):
            if key in state_dict:
                w = _t(state_dict[key]).reshape(-1)
                if w.shape[0] != ch:
                    raise ValueError(f"{key}: {w.shape[0]} channels, want {ch}")
                params[f"lin_{i}"] = w
                break
    return params


def _convert_by_shape(named_tensors) -> Dict[str, torch.Tensor]:
    """For opaque checkpoints (NVIDIA's ``vgg16.pt`` torchscript): the 13
    trunk convs matched by their (O, I, 3, 3) shape sequence, their biases by
    name (zeros when absent), the five LPIPS lin convs by (1, C, 1, 1)."""
    named_tensors = [(k, np.asarray(v)) for k, v in named_tensors]
    convs = [(k, v) for k, v in named_tensors if v.ndim == 4 and v.shape[2:] == (3, 3)]
    lins = [(k, v) for k, v in named_tensors
            if v.ndim == 4 and v.shape[0] == 1 and v.shape[2:] == (1, 1)]
    biases = {k: v for k, v in named_tensors if v.ndim == 1}

    sd = {}
    prev_ch, ci = 3, 0
    for idx, ch in _CONV_PLAN:
        while ci < len(convs) and convs[ci][1].shape[:2] != (ch, prev_ch):
            ci += 1
        if ci >= len(convs):
            raise ValueError(f"no conv with shape ({ch},{prev_ch},3,3) for features.{idx}")
        name, w = convs[ci]
        ci += 1
        b = biases.get(name.rsplit(".", 1)[0] + ".bias")
        if b is None or b.shape[0] != ch:
            b = np.zeros((ch,), np.float32)
        sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = _t(w), _t(b)
        prev_ch = ch
    li = 0
    for i, ch in enumerate(_TAP_CHANNELS):
        w = None
        for j in range(li, len(lins)):
            if lins[j][1].shape[1] == ch:
                w, li = lins[j][1].reshape(-1), j + 1
                break
        sd[f"lin_{i}"] = _t(w) if w is not None else torch.ones(ch)
    return sd


def load_vgg16_file(path: str) -> Dict[str, torch.Tensor]:
    """The port's VGG16 state dict from a checkpoint of any flavour:
    torchscript (NVIDIA ``vgg16.pt``, read with ``torch.jit.load``), a
    torchvision state dict, or a richzhang LPIPS checkpoint (its trunk under
    ``net.slice{n}.{i}``, torchvision's indices kept inside each slice)."""
    try:
        mod = torch.jit.load(path, map_location="cpu")
    except (RuntimeError, ValueError):
        mod = None
    if mod is not None:
        return _convert_by_shape([(k, v.detach().numpy())
                                  for k, v in mod.state_dict().items()])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in sd.items()}
    if any(k.startswith("features.") for k in sd):
        return load_torchvision_vgg16(sd)
    if any("lin" in k for k in sd) and any(".slice" in k or "net." in k for k in sd):
        trunk = {}
        for k, v in sd.items():
            if ".slice" in k:
                parts = k.split(".")
                trunk[f"features.{parts[-2]}.{parts[-1]}"] = v
        return load_lpips_linear(sd, load_torchvision_vgg16(trunk))
    return _convert_by_shape(list(sd.items()))


class LPIPSEvaluator:
    """LPIPS features and distances on ``device`` (CUDA unless named).

    ``weights_path`` (or ``$ICGAN_VGG16_WEIGHTS``) may name a checkpoint of
    any flavour ``load_vgg16_file`` reads; without one the trunk runs with
    random weights from a generator seeded 0 (on the CPU, so the same on
    every device), self-consistent only.  Images: NCHW in [-1, 1], moved to
    the net's [0, 255] here (the reference's dynamic-range hop,
    ``perceptual_path_length.py:107``).  Float32 throughout, without TF32
    (``eval.fid.full_f32``)."""

    def __init__(self, weights_path: Optional[str] = None, device=None):
        weights_path = weights_path or os.environ.get("ICGAN_VGG16_WEIGHTS")
        self.device = resolve_device(device)
        self.net = VGG16(device="cpu", generator=torch.Generator().manual_seed(0))
        self.pretrained = bool(weights_path and os.path.exists(weights_path))
        if self.pretrained:
            self.net.load_state_dict(load_vgg16_file(weights_path))
        self.net.to(self.device)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The LPIPS feature vectors; differentiable in ``images`` when they
        require a gradient (the projector's loss), else computed in
        inference mode."""
        x = torch.as_tensor(images, device=self.device, dtype=torch.float32)
        mode = contextlib.nullcontext() if x.requires_grad else torch.inference_mode()
        with mode, full_f32():
            return self.net.lpips_features((x + 1.0) * 127.5)

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), full_f32():
            a = torch.as_tensor(a, device=self.device, dtype=torch.float32)
            b = torch.as_tensor(b, device=self.device, dtype=torch.float32)
            return self.net.lpips_distance((a + 1.0) * 127.5, (b + 1.0) * 127.5)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.features(images)
