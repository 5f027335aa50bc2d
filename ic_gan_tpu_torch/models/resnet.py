"""ResNet-50 instance-feature extractor in PyTorch (NCHW, frozen).

Port of ``ic_gan_tpu/models/resnet.py`` (upstream ``data_utils/resnet.py:
77-154``): a torchvision-layout ResNet-50 returning ``(pooled features or
logits, conv features)``.  IC-GAN conditions on the 2048-d pooled features
of SwAV (self-supervised) or ImageNet-classification weights.  Module names
are torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{b}.conv{1-3}``,
``.downsample.{0,1}``, ``fc``), so a torchvision state dict loads as it is;
``load_torch_resnet50`` strips the SwAV and DDP prefixes first.

The network extracts features only: batch norm is always the fixed affine
of its stored statistics (eps 1e-5), in training mode too.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ic_gan_tpu_torch import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its parameters, buffers and state-dict keys) that
    always normalizes with its running statistics."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _conv(cin, cout, k, stride=1, device=None):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, device=device)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride) → 1×1 ×4, each with batch norm, plus the
    identity or a strided 1×1 projection (torchvision v1.5)."""

    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False,
                 device=None):
        super().__init__()
        self.conv1 = _conv(cin, width, 1, device=device)
        self.bn1 = FrozenBatchNorm2d(width, device=device)
        self.conv2 = _conv(width, width, 3, stride, device=device)
        self.bn2 = FrozenBatchNorm2d(width, device=device)
        self.conv3 = _conv(width, 4 * width, 1, device=device)
        self.bn3 = FrozenBatchNorm2d(4 * width, device=device)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(_conv(cin, 4 * width, 1, stride, device=device),
                                            FrozenBatchNorm2d(4 * width, device=device))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet50(nn.Module):
    """``forward(x) -> (pooled or logits, conv features)``: x (N, 3, H, W),
    ImageNet-normalized (``preprocess``); the 2048-d global average pool, or
    with ``classifier`` the ``fc`` logits, and the last stage's (N, 2048,
    H/32, W/32) features.  Float32, on ``device`` (default CUDA), with
    torchvision's init drawn from ``generator`` (He-normal convs, batch norm
    the identity)."""

    def __init__(self, classifier: bool = False, num_classes: int = 1000, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.classifier = classifier
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = FrozenBatchNorm2d(64, device=device)
        cin = 64
        for i, (blocks, width, stride) in enumerate(
                [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)], start=1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, width, stride if b == 0 else 1, b == 0,
                                        device=device))
                cin = 4 * width
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        if classifier:
            self.fc = nn.Linear(2048, num_classes, device=device)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                            generator=generator)
        self.eval()

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)   # pads with -inf
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        pooled = x.mean(dim=(2, 3))
        if self.classifier:
            return self.fc(pooled), x
        return pooled, x


def preprocess(images_01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(N, 3, H, W) images in [0, 1] → the bicubic resize to ``size``² and
    ImageNet normalization (the reference extracts features at 224²,
    ``make_hdf5.py:232-243``).  The resize antialiases and uses Keys' cubic
    with a = −0.5, as ``jax.image.resize(..., "bicubic")`` does; plain
    ``F.interpolate(mode="bicubic")`` (a = −0.75, no antialiasing) is 0.1–0.45
    away from it."""
    x = images_01.float()
    if x.shape[-2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bicubic", antialias=True,
                          align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


_PREFIXES = ("module.", "_feature_blocks.")
_TRUNK = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")


def load_torch_resnet50(state_dict: Mapping[str, torch.Tensor], classifier: bool = False,
                        device=None) -> ResNet50:
    """A ``ResNet50`` on ``device`` (default CUDA) holding a torchvision or
    SwAV ResNet-50 state dict.  The reference's shims
    (``data_utils/utils.py:322-355``): the ``module.`` (DDP) and
    ``_feature_blocks.`` (SwAV) prefixes are stripped, and everything outside
    the trunk (SwAV's projection head and prototypes) is dropped, ``fc`` too
    unless ``classifier``.  The trunk must be whole."""
    sd = {}
    for key, value in state_dict.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
        if key.startswith(_TRUNK) or (classifier and key.startswith("fc.")):
            sd[key] = torch.as_tensor(value)
    net = skip_init(ResNet50, classifier=classifier, device=resolve_device(device))
    result = net.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"ResNet-50 state dict: missing {missing[:10]}, "
                       f"unexpected {result.unexpected_keys[:10]}")
    return net.eval()
