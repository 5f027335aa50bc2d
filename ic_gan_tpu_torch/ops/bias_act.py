"""Fused bias + activation + gain + clamp: ``clamp(gain·act(x + b))``.

Port of ``ic_gan_tpu/ops/bias_act.py`` (the activation table and the plain
formula) and of its Pallas twin ``ic_gan_tpu/ops/pallas/bias_act.py``
(``bias_act_fused``).  The bias lies along ``dim`` (1 for NCHW activations
and for (N, C) features), so neither layout needs a transpose.

``bias_act`` is ``BiasAct.apply``, the counterpart of the JAX ``custom_jvp``:
on CUDA tensors its forward launches ``csrc/bias_act.cu`` (one pass, computed
in float32, rounded once to the input's type); on CPU tensors it runs the
plain version ``bias_act_ref``.  Its backward is written in torch ops, the
derivative of the plain formula, so R1 and path-length regularization can
differentiate through it to any order; it launches no kernel.  Each launch
adds one to ``bias_act_fwd.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ic_gan_tpu_torch.ops import _build

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


class _Act(NamedTuple):
    fn: Callable          # act(v)
    grad: Callable        # d act / d v, in torch ops of v (differentiable)
    def_gain: float
    code: int             # the kernel's activation code


def _lrelu(v, alpha=0.2):
    return torch.where(v >= 0, v, v * alpha)


activation_funcs = {
    "linear": _Act(lambda v: v, lambda v: torch.ones_like(v), 1.0, 0),
    "relu": _Act(lambda v: torch.clamp_min(v, 0.0), lambda v: (v > 0).to(v.dtype),
                 math.sqrt(2.0), 1),
    "lrelu": _Act(_lrelu, lambda v: torch.where(v >= 0, 1.0, 0.2).to(v.dtype),
                  math.sqrt(2.0), 2),
    "tanh": _Act(torch.tanh, lambda v: 1.0 - torch.tanh(v) ** 2, 1.0, 3),
    "sigmoid": _Act(torch.sigmoid,
                    lambda v: torch.sigmoid(v) * (1.0 - torch.sigmoid(v)), 1.0, 4),
    "elu": _Act(F.elu, lambda v: torch.where(v > 0, torch.ones_like(v), torch.exp(v)),
                1.0, 5),
    "selu": _Act(F.selu, lambda v: _SELU_SCALE * torch.where(
        v > 0, torch.ones_like(v), _SELU_ALPHA * torch.exp(v)), 1.0, 6),
    "softplus": _Act(lambda v: torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())),
                     torch.sigmoid, 1.0, 7),
    "swish": _Act(F.silu, lambda v: torch.sigmoid(v) * (1.0 + v * (1.0 - torch.sigmoid(v))),
                  math.sqrt(2.0), 8),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _grad_ref(gy, x, b, dim, act, alpha, gain, clamp):
    """d out / d (x, b) applied to ``gy``, in differentiable torch ops of x
    and b; clamped elements get zero gradient, as ``jnp.clip`` gives."""
    spec, alpha, gain = _spec(act, alpha, gain)
    v = _pre(x, b, dim)
    if act == "lrelu":
        d = torch.where(v >= 0, 1.0, alpha).to(v.dtype)
    else:
        d = spec.grad(v)
    gx = gy * d if gain == 1.0 else gy * (d * gain)
    if clamp is not None and clamp >= 0:
        y = _lrelu(v, alpha) if act == "lrelu" else spec.fn(v)
        gx = torch.where((y * gain).abs() <= clamp, gx, torch.zeros_like(gx))
    gb = None
    if b is not None:
        dims = [i for i in range(x.dim()) if i != dim % x.dim()]
        gb = gx.sum(dim=dims).to(b.dtype)
    return gx, gb


def _entry():
    fn = _build.load("bias_act").bias_act_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_float,
                                               ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bias_act_fwd(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
                 act: str = "linear", alpha: Optional[float] = None,
                 gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """The forward alone.  CPU tensors take ``bias_act_ref``; CUDA tensors
    launch the kernel on the current stream, or raise."""
    if x.device.type == "cpu" and (b is None or b.device.type == "cpu"):
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    spec, alpha, gain = _spec(act, alpha, gain)
    if x.device.type != "cuda":
        raise ValueError(f"bias_act runs on CPU or CUDA, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"bias_act takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    dim = dim % x.dim()
    C = x.shape[dim]
    if b is not None:
        if b.device != x.device or b.dtype != x.dtype or tuple(b.shape) != (C,) \
                or not b.is_contiguous():
            raise ValueError(f"b must be a contiguous ({C},) {x.dtype} tensor on "
                             f"{x.device}, got {tuple(b.shape)} {b.dtype} on {b.device}")
    inner = math.prod(x.shape[dim + 1:])
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                 n, C, inner, spec.code, alpha, gain,
                 -1.0 if clamp is None or clamp < 0 else float(clamp),
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"bias_act launch failed: cudaError {err}")
    bias_act_fwd.launches += 1
    return y


bias_act_fwd.launches = 0


class BiasAct(torch.autograd.Function):
    """``clamp(gain·act(x + b))`` with the kernel as forward and the plain
    formula's derivative, in torch ops, as backward (the JAX ``custom_jvp``
    runs its tangents through the XLA formula the same way)."""

    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (dim, act, alpha, gain, clamp)
        return bias_act_fwd(x.contiguous(), None if b is None else b.contiguous(),
                            dim, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, gy):
        x, b = ctx.saved_tensors
        gx, gb = _grad_ref(gy, x, b, *ctx.args)
        return (gx if ctx.needs_input_grad[0] else None,
                gb if ctx.needs_input_grad[1] else None,
                None, None, None, None, None)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """``clamp(gain·act(x + b))`` along channel ``dim``, differentiable to
    any order.  ``gain`` and ``clamp`` default to the activation's gain and
    no clamping (reference ``bias_act.py:131-162``)."""
    return BiasAct.apply(x, b, dim, act, alpha, gain, clamp)


def bias_act_fused(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                   act: str = "linear", gain: Optional[float] = None,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """The counterpart of the JAX package's ``bias_act_fused`` over the
    port's layout (channels on dim 1); it has no shape gate."""
    return bias_act(x, b, 1, act, None, gain, clamp)
