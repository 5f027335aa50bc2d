"""Fused bias + activation + gain + clamp: ``clamp(gain·act(x + b))``.

Port of ``ic_gan_tpu/ops/bias_act.py`` (the activation table and the plain
formula) and of its Pallas twin ``ic_gan_tpu/ops/pallas/bias_act.py``
(``bias_act_fused``).  The bias lies along ``dim`` (1 for NCHW activations
and for (N, C) features), so neither layout needs a transpose.

``bias_act`` is ``BiasAct.apply``, the counterpart of the JAX ``custom_jvp``,
wherever a gradient is wanted; at inference it calls the forward as the
``torch.library`` op ``ic_gan_tpu::bias_act_fwd``, which ``torch.export``
keeps in a program (``io/deploy.py:export_sampler``).
On CUDA tensors its forward launches ``csrc/bias_act.cu:bias_act_fwd`` and
its backward ``bias_act_bwd`` (each one pass, computed in float32, rounded
once to the input's type); on CPU tensors both run their plain versions
(``bias_act_ref``, ``_grad_x_ref``).  The backward is ``BiasActGrad``, which
gives ``gx`` from ``gy`` and ``x``; the bias gradient is its sum in torch.
``BiasActGrad`` differentiates again to any order: it is linear in ``gy``, so
its own backward launches the same kernel on the incoming gradient, and its
derivative in ``x`` uses the second derivatives of ``activation_funcs``
(zero for linear, relu and lrelu).  So R1 and path-length regularization run
their second order through the kernels too.  Each launch adds one to
``bias_act_fwd.launches`` or ``bias_act_bwd.launches`` (``reset_launches``).
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRIES: dict = {}   # name -> the loaded ctypes function, its types set


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


def _entry(name):
    fn = _ENTRIES.get(name)
    if fn is not None:
        return fn
    fn = getattr(_build.load("bias_act"), name)
    if fn.argtypes is None:
        pointers = 3 if name == "bias_act_fwd" else 4
        fn.argtypes = [ctypes.c_void_p] * pointers + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _ENTRIES[name] = fn
    return fn


def _launch(name, tensors, b, dim, act, alpha, gain, clamp):
    """Check ``tensors`` (x, or gy and x) and ``b`` for the kernel, launch
    ``name`` on the current stream and return its output; raises on what
    the kernel does not take or a failed launch.  The checks read tensor
    attributes that build no Python objects: this runs at every launch."""
    spec, alpha, gain = _spec(act, alpha, gain)
    x = tensors[-1]
    if not x.is_cuda:
        raise ValueError(f"bias_act runs on CPU or CUDA, not {x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"bias_act takes float32 or bfloat16, got {x.dtype}")
    index = x.get_device()
    for t in tensors:
        if t.get_device() != index or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"gy and x must match: {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"against {tuple(x.shape)} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError("bias_act's tensors must be contiguous")
    dim = dim % x.dim()
    C = x.shape[dim]
    if b is not None:
        if b.get_device() != index or b.dtype != x.dtype or b.shape != (C,) \
                or not b.is_contiguous():
            raise ValueError(f"b must be a contiguous ({C},) {x.dtype} tensor on "
                             f"{x.device}, got {tuple(b.shape)} {b.dtype} on {b.device}")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    fn = _entry(name)
    with _build.on_device(index):
        err = fn(*(t.data_ptr() for t in tensors), None if b is None else b.data_ptr(),
                 out.data_ptr(), n, C, math.prod(x.shape[dim + 1:]), spec.code, alpha, gain,
                 -1.0 if clamp is None or clamp < 0 else float(clamp), code,
                 _build.raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def _on_cpu(*tensors):
    return all(t is None or t.is_cpu for t in tensors)


def bias_act_fwd(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
                 act: str = "linear", alpha: Optional[float] = None,
                 gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """The forward alone.  CPU tensors take ``bias_act_ref``; CUDA tensors
    launch the kernel on the current stream, or raise."""
    if _on_cpu(x, b):
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    y = _launch("bias_act_fwd", (x,), b, dim, act, alpha, gain, clamp)
    if x.numel():
        bias_act_fwd.launches += 1
    return y


def bias_act_bwd(gy: torch.Tensor, x: torch.Tensor, b: Optional[torch.Tensor] = None,
                 dim: int = 1, act: str = "linear", alpha: Optional[float] = None,
                 gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """``gx = gy·gain·act′(x + b)``, zero where the clamp cut the output, in
    one pass.  CPU tensors take ``_grad_x_ref``; CUDA tensors launch the
    kernel on the current stream, or raise."""
    if _on_cpu(gy, x, b):
        return _grad_x_ref(gy, x, b, dim, act, alpha, gain, clamp)
    gx = _launch("bias_act_bwd", (gy, x), b, dim, act, alpha, gain, clamp)
    if x.numel():
        bias_act_bwd.launches += 1
    return gx


bias_act_fwd.launches = 0
bias_act_bwd.launches = 0


def reset_launches():
    bias_act_fwd.launches = bias_act_bwd.launches = 0


def _contiguous(t):
    return None if t is None else t.contiguous()


class BiasAct(torch.autograd.Function):
    """``clamp(gain·act(x + b))``: the forward kernel, and ``BiasActGrad``
    (the backward kernel) for ``gx``, summed over the other dims for ``gb``
    (the split of upstream's ``BiasActCuda.backward``; the JAX ``custom_jvp``
    runs its tangents through the XLA formula in one fused pass)."""

    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (dim, act, alpha, gain, clamp)
        return bias_act_fwd(x.contiguous(), _contiguous(b), dim, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, gy):
        x, b = ctx.saved_tensors
        with torch.profiler.record_function("bias_act_bwd"):
            gx = BiasActGrad.apply(gy, x, b, *ctx.args)
            gb = _sum_to_bias(gx, b, ctx.args[0]) \
                if b is not None and ctx.needs_input_grad[1] else None
        return (gx if ctx.needs_input_grad[0] else None, gb, None, None, None, None, None)


class BiasActGrad(torch.autograd.Function):
    """``gx`` of ``BiasAct`` from ``gy`` and ``x``, in one kernel pass, and
    differentiable again: in ``gy`` it is linear, so its backward is this
    Function on the incoming gradient ``ggx``; in ``x`` (and ``b``, the sum)
    it is ``ggx·gy·gain·act″(x + b)`` under the same clamp mask, computed in
    torch ops, and zero for linear, relu and lrelu."""

    @staticmethod
    def forward(ctx, gy, x, b, dim, act, alpha, gain, clamp):
        ctx.save_for_backward(gy, x, b)
        ctx.args = (dim, act, alpha, gain, clamp)
        return bias_act_bwd(gy.contiguous(), x.contiguous(), _contiguous(b), dim, act, alpha,
                            gain, clamp)

    @staticmethod
    def backward(ctx, ggx):
        gy, x, b = ctx.saved_tensors
        dim, act, alpha, gain, clamp = ctx.args
        need_gy, need_x, need_b = ctx.needs_input_grad[:3]
        d_gy = BiasActGrad.apply(ggx, x, b, *ctx.args) if need_gy else None
        spec, alpha, gain = _spec(act, alpha, gain)
        d_x = d_b = None
        if spec.grad2 is not None and (need_x or need_b):
            v = _pre(x, b, dim)
            h = ggx * gy * (spec.grad2(v) * gain)
            if clamp is not None and clamp >= 0:
                h = torch.where(_clamp_mask(v, act, spec, alpha, gain, clamp), h,
                                torch.zeros_like(h))
            d_x = h if need_x else None
            d_b = _sum_to_bias(h, b, dim) if need_b and b is not None else None
        return (d_gy, d_x, d_b, None, None, None, None, None)


@torch.library.custom_op("ic_gan_tpu::bias_act_fwd", mutates_args=(), device_types="cuda")
def _bias_act_op(x: torch.Tensor, b: Optional[torch.Tensor], dim: int, act: str,
                 alpha: Optional[float], gain: Optional[float],
                 clamp: Optional[float]) -> torch.Tensor:
    """The forward as a ``torch.library`` op, so that ``torch.export`` keeps
    it in a program (a ctypes launch cannot be traced): on CUDA the kernel
    launch, counted as every launch is."""
    return bias_act_fwd(x, b, dim, act, alpha, gain, clamp)


@_bias_act_op.register_kernel("cpu")
def _(x, b, dim, act, alpha, gain, clamp):
    y = bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    return y.clone() if y is x else y   # an op's output never aliases its input


@_bias_act_op.register_fake
def _(x, b, dim, act, alpha, gain, clamp):
    return torch.empty_like(x)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """``clamp(gain·act(x + b))`` along channel ``dim``, differentiable to
    any order.  ``gain`` and ``clamp`` default to the activation's gain and
    no clamping (reference ``bias_act.py:131-162``).  Where no gradient is
    wanted it calls the forward as the op ``torch.ops.ic_gan_tpu.bias_act_fwd``,
    which an exported program keeps."""
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
    devices = {x.device} if b is None else {x.device, b.device}
    if len(devices) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bias_act runs on CPU or CUDA tensors on one device, got {devices}")
    return torch.ops.ic_gan_tpu.bias_act_fwd(x.contiguous(), _contiguous(b), dim, act, alpha,
                                             gain, clamp)


def bias_act_fused(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                   act: str = "linear", gain: Optional[float] = None,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """The counterpart of the JAX package's ``bias_act_fused`` over the
    port's layout (channels on dim 1); it has no shape gate."""
    return bias_act(x, b, 1, act, None, gain, clamp)
