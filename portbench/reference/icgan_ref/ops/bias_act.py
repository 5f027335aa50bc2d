"""Bias + activation + gain + clamp, ``clamp(gain·act(x + b))``, in plain
PyTorch: the port's plain formula, differentiated by autograd to any order
(no kernel)."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


class _Act(NamedTuple):
    fn: Callable          # act(v)
    grad: Callable        # d act / d v, in torch ops of v (differentiable)
    grad2: Optional[Callable]  # d² act / d v², in torch ops; None where it is 0
    def_gain: float
    code: int             # the kernel's activation code


def _lrelu(v, alpha=0.2):
    return torch.where(v >= 0, v, v * alpha)


def _dsigmoid(v):
    s = torch.sigmoid(v)
    return s * (1.0 - s)


activation_funcs = {
    "linear": _Act(lambda v: v, lambda v: torch.ones_like(v), None, 1.0, 0),
    "relu": _Act(lambda v: torch.clamp_min(v, 0.0), lambda v: (v > 0).to(v.dtype), None,
                 math.sqrt(2.0), 1),
    "lrelu": _Act(_lrelu, lambda v: torch.where(v >= 0, 1.0, 0.2).to(v.dtype), None,
                  math.sqrt(2.0), 2),
    "tanh": _Act(torch.tanh, lambda v: 1.0 - torch.tanh(v) ** 2,
                 lambda v: -2.0 * torch.tanh(v) * (1.0 - torch.tanh(v) ** 2), 1.0, 3),
    "sigmoid": _Act(torch.sigmoid, _dsigmoid,
                    lambda v: _dsigmoid(v) * (1.0 - 2.0 * torch.sigmoid(v)), 1.0, 4),
    "elu": _Act(F.elu, lambda v: torch.where(v > 0, torch.ones_like(v), torch.exp(v)),
                lambda v: torch.where(v > 0, torch.zeros_like(v), torch.exp(v)), 1.0, 5),
    "selu": _Act(F.selu, lambda v: _SELU_SCALE * torch.where(
        v > 0, torch.ones_like(v), _SELU_ALPHA * torch.exp(v)),
        lambda v: _SELU_SCALE * torch.where(v > 0, torch.zeros_like(v),
                                            _SELU_ALPHA * torch.exp(v)), 1.0, 6),
    "softplus": _Act(lambda v: torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())),
                     torch.sigmoid, _dsigmoid, 1.0, 7),
    "swish": _Act(F.silu, lambda v: torch.sigmoid(v) * (1.0 + v * (1.0 - torch.sigmoid(v))),
                  lambda v: _dsigmoid(v) * (2.0 + v * (1.0 - 2.0 * torch.sigmoid(v))),
                  math.sqrt(2.0), 8),
}



def _spec(act, alpha, gain):
    spec = activation_funcs[act]
    gain = spec.def_gain if gain is None else float(gain)
    alpha = 0.2 if alpha is None else float(alpha)
    return spec, alpha, gain


def _pre(x, b, dim):
    if b is None:
        return x
    shape = [1] * x.dim()
    shape[dim] = -1
    return x + b.reshape(shape)


def bias_act_ref(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
                 act: str = "linear", alpha: Optional[float] = None,
                 gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """The plain formula, as ``ic_gan_tpu/ops/bias_act.py:bias_act``: every
    step in x's type; ``gain`` defaults to the activation's gain; ``alpha``
    (lrelu only) to 0.2; no clamp unless ``clamp`` ≥ 0."""
    spec, alpha, gain = _spec(act, alpha, gain)
    v = _pre(x, b, dim)
    v = _lrelu(v, alpha) if act == "lrelu" else spec.fn(v)
    if gain != 1.0:
        v = v * gain
    if clamp is not None and clamp >= 0:
        v = torch.clamp(v, -clamp, clamp)
    return v


def _clamp_mask(v, act, spec, alpha, gain, clamp):
    """Where the clamp lets the gradient through: |gain·act(v)| ≤ clamp (the
    edge kept), as ``jnp.clip``'s derivative gives away from the edge."""
    y = _lrelu(v, alpha) if act == "lrelu" else spec.fn(v)
    return (y * gain).abs() <= clamp


def _grad_x_ref(gy, x, b, dim, act, alpha, gain, clamp):
    """d out / d x applied to ``gy``, in differentiable torch ops of x and b;
    clamped elements get zero gradient."""
    spec, alpha, gain = _spec(act, alpha, gain)
    v = _pre(x, b, dim)
    if act == "lrelu":
        d = torch.where(v >= 0, 1.0, alpha).to(v.dtype)
    else:
        d = spec.grad(v)
    gx = gy * d if gain == 1.0 else gy * (d * gain)
    if clamp is not None and clamp >= 0:
        gx = torch.where(_clamp_mask(v, act, spec, alpha, gain, clamp), gx,
                         torch.zeros_like(gx))
    return gx


def _sum_to_bias(g, b, dim):
    """The bias gradient: ``g`` summed over every dim but ``dim``."""
    dims = [i for i in range(g.dim()) if i != dim % g.dim()]
    return g.sum(dim=dims).to(b.dtype)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """``clamp(gain·act(x + b))`` along channel ``dim``."""
    return bias_act_ref(x, b, dim, act, alpha, gain, clamp)


def bias_act_fused(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                   act: str = "linear", gain: Optional[float] = None,
                   clamp: Optional[float] = None) -> torch.Tensor:
    return bias_act(x, b, 1, act, None, gain, clamp)
