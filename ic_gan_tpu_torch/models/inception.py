"""InceptionV3 feature network for FID/IS, in PyTorch (NCHW).

Port of ``ic_gan_tpu/models/inception.py``: the torchvision ``inception_v3``
graph the reference wraps for its metrics (``data_utils/inception_utils.py:
42-102``; pool3 features at 299², logits without aux).  Submodule and
parameter names are torchvision's (``<m>.conv.weight``,
``<m>.bn.{weight,bias,running_mean,running_var}``, ``fc.*``), so a
torchvision state dict loads with ``load_state_dict`` once its ``AuxLogits.*``
and ``num_batches_tracked`` entries are dropped (``load_torch_inception``).

Eval only: batch norm always uses the stored statistics.  ``dtype`` is the
compute dtype of the trunk's convs and its resize (``torch.bfloat16`` is
the ``eval_bf16`` deployment mode); parameters stay float32, batch norm and
ReLU run in float32 on each conv's output, and the global pool and the
``fc`` logits are float32 whatever the trunk's dtype.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ic_gan_tpu_torch import resolve_device

# torchvision's BasicConv2d BatchNorm2d(eps=0.001), not the 1e-5 default:
# 1e-5 shifts FID.
BN_EPS = 1e-3


class FrozenBatchNorm(nn.Module):
    """Batch norm with stored statistics, under torchvision's names and
    without ``num_batches_tracked``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        """The affine of ``x`` in float32, whatever its dtype (``addcmul``
        promotes a bf16 ``x`` as it reads it)."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + BN_EPS)
        shift = self.bias.float() - self.running_mean.float() * scale
        return torch.addcmul(shift[:, None, None], x, scale[:, None, None])


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        # The conv in the compute dtype; batch norm and ReLU in float32,
        # rounded once to the compute dtype.  (The JAX package applies the
        # affine in the compute dtype, :54-55: three bf16 roundings a layer,
        # whose drift from float32 reaches 0.16-0.18 of the mean pool
        # feature at random weights, past the 0.15 bar; one rounding keeps
        # it near 0.10.)
        y = F.conv2d(x, self.conv.weight.to(x.dtype), None, self.conv.stride,
                     self.conv.padding)
        return F.relu(self.bn(y)).to(x.dtype)


def _avgpool3(x):
    # torchvision's branch_pool: F.avg_pool2d(x, 3, 1, 1) with the default
    # count_include_pad=True, so the divisor is always 9.
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)  # VALID padding


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        # The concat order is the feature-channel order FID reads.
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avgpool3(x)),
        ], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            _maxpool3s2(x),
        ], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for m in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avgpool3(x)),
        ], dim=1)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize on the corner-aligned grid (output pixel i samples
    input coordinate i·(in−1)/(out−1)), as the reference's ``WrapInception``
    resizes (``inception_utils.py:59``)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class InceptionV3(nn.Module):
    """``forward(x) -> (pool (N, 2048), logits (N, 1000))``, both float32,
    like the reference wrapper (``inception_utils.py:87-102``).

    Input: NCHW in [-1, 1] at any resolution; mapped to ImageNet-normalized
    values in the input's precision, cast to ``dtype``, then resized to 299²
    on the corner-aligned bilinear grid unless already 299², as
    ``WrapInception.forward`` (``inception_utils.py:58-86``)."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        with torch.device("meta"):
            self._build()
        self.to_empty(device=device)
        self.reset_parameters(generator)
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406], device=device),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225], device=device),
                             persistent=False)

    def _build(self):
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights: He-normal convs (std √(2/fan_in), which keeps the
        activations' scale through the ReLUs), batch norm the identity, a
        LeCun-normal ``fc`` with a zero bias; drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                w.normal_(0.0, (2.0 / w[0].numel()) ** 0.5, generator=generator)
                m.bn.weight.fill_(1.0)
                m.bn.bias.zero_()
                m.bn.running_mean.zero_()
                m.bn.running_var.fill_(1.0)
        self.fc.weight.normal_(0.0, (1.0 / 2048) ** 0.5, generator=generator)
        self.fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        mean = self.mean.to(x.dtype)[:, None, None]
        std = self.std.to(x.dtype)[:, None, None]
        x = ((x + 1.0) / 2.0 - mean) / std
        x = x.to(self.dtype)
        if tuple(x.shape[2:]) != (299, 299):
            x = resize_bilinear_align_corners(x, 299, 299)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        # Pool and logits in float32 whatever the trunk's dtype: FID's
        # moments are quadratic in these features.
        pool = x.float().mean(dim=(2, 3))
        logits = F.linear(pool, self.fc.weight.float(), self.fc.bias.float())
        return pool, logits


def load_torch_inception(state_dict: Mapping) -> dict:
    """A torchvision ``inception_v3`` state dict (tensors or numpy arrays) →
    the port's state dict (float32 CPU tensors): ``AuxLogits.*`` and
    ``num_batches_tracked`` dropped."""
    return {k: torch.as_tensor(v).float().clone() for k, v in state_dict.items()
            if not k.startswith("AuxLogits") and not k.endswith("num_batches_tracked")}
