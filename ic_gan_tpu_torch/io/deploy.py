"""Deployment-mode weight preparation and the fixed-batch sampler.

Port of ``ic_gan_tpu/io/deploy.py``.  ``fold_spectral_norm`` divides every
spectrally normalized weight by its eval-mode σ once, so a forward runs no
power iteration.  ``cast_params`` stores the weights in bfloat16, keeping the
batch-norm statistics (buffers) in float32.  ``make_sampler`` runs a folded
generator over requests of any size in fixed batches, padding the tail.
``accumulate_standing_stats`` drives BigGAN's standing-statistics eval mode.
All of them change the module in place.  ``export_sampler`` saves the
fixed-batch forward with its weights as one ``torch.export`` program, which
``load_exported_sampler`` runs without the model code.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.models.layers import _SpectralNormed
from ic_gan_tpu_torch.models.stylegan2 import _Filtered
from ic_gan_tpu_torch.parallel import collectives
from ic_gan_tpu_torch.parallel.mesh import shard_rows


def fold_spectral_norm(module: nn.Module) -> nn.Module:
    """Bake σ into every spectrally normalized weight of ``module`` and drop
    the ``u0``/``sv0`` buffers; the layers then skip the power iteration.
    A folded module loads a folded ``state_dict``."""
    for m in module.modules():
        if isinstance(m, _SpectralNormed):
            m.fold_()
    return module


def cast_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast the floating-point parameters to ``dtype``.  Buffers stay as they
    are: batch-norm statistics (which parameterize a rsqrt) in float32, and
    the int8 serving mode's codes and float32 scales (``io/quant.py``;
    rounding a scale to bf16 would add a systematic gain error per
    channel)."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


def set_compute_dtype(g: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Switch a built BigGAN or BigGAN-deep G to compute in ``dtype``: every
    layer's ``dtype`` and ``g.cfg.dtype``.  The int8 serving mode calibrates
    in the config's type and serves in bf16 after this and ``cast_params``."""
    for m in g.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    g.cfg = g.cfg.replace(dtype=dtype)
    return g


def reset_standing_stats(module: nn.Module) -> nn.Module:
    """Zero every batch norm's (stored_mean, stored_var, accum_counter) so a
    fresh standing-statistics accumulation can begin.  Only the ``bn`` style
    keeps a counter; an ``in`` style keeps its running statistics, as the
    JAX package's reset leaves them."""
    with torch.no_grad():
        for m in module.modules():
            if "accum_counter" in m._buffers:
                m.stored_mean.zero_()
                m.stored_var.zero_()
                m.accum_counter.zero_()
    return module


def accumulate_standing_stats(
    g: nn.Module,
    generator: torch.Generator,
    sample_conditioning: Optional[Callable[[int], tuple]] = None,
    *,
    batch_size: int = 32,
    n_accumulations: int = 16,
) -> nn.Module:
    """Reset the statistics, then run ``n_accumulations`` standing-mode
    forwards with fresh z ~ N(0, 1) from ``generator`` (on g's device) and
    fresh conditioning ``sample_conditioning(n) -> (label, feats)``; eval
    then normalizes with the averaged moments (ref ``utils.py:1679-1695``)."""
    reset_standing_stats(g)
    device = next(g.parameters()).device
    with torch.inference_mode():
        for _ in range(n_accumulations):
            z = torch.randn((batch_size, g.cfg.effective_dim_z), device=device,
                            generator=generator)
            label = feats = None
            if sample_conditioning is not None:
                label, feats = sample_conditioning(batch_size)
                label = None if label is None else torch.as_tensor(label, device=device)
                feats = None if feats is None else torch.as_tensor(feats, device=device)
            g(z, label, feats, standing=True)
    return g


def make_sampler(g: nn.Module, *, batch_size: Optional[int] = None, device=None,
                 mesh=None, **apply_kwargs):
    """``sampler(z, label=None, feats=None, device_output=False)`` running
    ``g(z, label, feats, **apply_kwargs)`` (g moved to ``device``, default
    CUDA) in batches of ``batch_size``: the StyleGAN2 generator takes
    ``truncation_psi`` and ``noise_mode`` so.

    Folds spectral norm in place first, so no forward runs a power
    iteration (a StyleGAN2 generator has none, and is left as it is); cast
    the weights beforehand with ``cast_params`` to sample in bf16.  A
    request of any size runs in full batches, the tail padded with copies of
    its first row, so every launch sees one shape.  Returns NHWC
    images, float32: a numpy array, or with ``device_output`` a tensor left
    on the device for a consumer there.

    With ``mesh`` (``parallel.mesh``; ``batch_size`` must divide by its
    ranks) every rank passes the same request, generates its share of each
    batch, and returns the whole request's images.
    """
    device = resolve_device(device)
    if mesh is not None and not mesh.holds_share:
        raise ValueError("this rank holds no share of the mesh")
    fold_spectral_norm(g.to(device).eval())

    def run(*args):
        if mesh is None:
            return g(*args, **apply_kwargs)
        with collectives.data_parallel(mesh):   # per-sample draws: the batch's
            img = g(*(None if a is None else shard_rows(a, mesh) for a in args),
                    **apply_kwargs)
        return collectives.all_gather(img, mesh)

    def sampler(z, label=None, feats=None, device_output: bool = False):
        n = z.shape[0]
        bs = batch_size or n
        if mesh is not None and bs % mesh.world:
            raise ValueError(f"a batch of {bs} does not divide over {mesh.world} ranks")
        outs = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                hi = min(lo + bs, n)
                pad = bs - (hi - lo)
                img = run(*(padded_rows(a, lo, hi, pad, device) for a in (z, label, feats)))
                outs.append(img[: hi - lo].permute(0, 2, 3, 1))
            out = torch.cat(outs) if len(outs) > 1 else outs[0].contiguous()
        return out if device_output else np.ascontiguousarray(out.cpu().numpy())

    # What ``eval.pipeline.make_fused_feature_fn`` runs G with.
    sampler.module, sampler.batch_size, sampler.apply_kwargs = g, batch_size, apply_kwargs
    return sampler


def padded_rows(a, lo: int, hi: int, pad: int, device):
    """Rows ``lo:hi`` of ``a`` (a tensor, an array or None) on ``device``,
    followed by ``pad`` copies of the first, so that a tail batch has the
    full batch's shape."""
    if a is None:
        return None
    a = torch.as_tensor(a[lo:hi], device=device)
    return torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) if pad else a


class _ExportedForward(nn.Module):
    """``g(z, label, feats, **apply_kwargs)`` → NHWC images, zero-width
    conditioning standing for none."""

    def __init__(self, g: nn.Module, apply_kwargs: dict):
        super().__init__()
        self.g, self.apply_kwargs = g, apply_kwargs

    def forward(self, z, label, feats):
        label = None if label.shape[-1] == 0 else label
        feats = None if feats.shape[-1] == 0 else feats
        return self.g(z, label, feats, **self.apply_kwargs).permute(0, 2, 3, 1)


def _sampler_signature(g: nn.Module, batch_size: int) -> list:
    """(shape, dtype) of (z, label or c, feats) for the export; a zero-width
    placeholder stands in for absent conditioning.  BigGAN (and BigGAN-deep)
    takes integer class labels and ``instance_sz`` features, StyleGAN2 a
    float ``c_dim`` vector and ``h_dim`` features."""
    cfg, b = g.cfg, batch_size
    if hasattr(cfg, "effective_dim_z"):
        return [((b, cfg.effective_dim_z), torch.float32),
                ((b,) if cfg.class_cond else (b, 0), torch.int64),
                ((b, cfg.instance_sz if cfg.instance_cond else 0), torch.float32)]
    return [((b, cfg.z_dim), torch.float32), ((b, cfg.c_dim), torch.float32),
            ((b, cfg.h_dim), torch.float32)]


def export_sampler(g: nn.Module, batch_size: int, *, device=None, **apply_kwargs) -> bytes:
    """The deployment sampler as the bytes of one saved ``torch.export``
    program: the forward ``g(z, label, feats, **apply_kwargs)`` (g moved to
    ``device``, default CUDA, σ folded) at a fixed batch, with its weights
    as they are: cast them first with ``cast_params``, quantize them with
    ``io/quant.py``.  The attention and bias-activation kernels stay in the
    program as the ops ``ic_gan_tpu::sagan_attention_fwd`` and
    ``ic_gan_tpu::bias_act_fwd``.  A StyleGAN2 generator needs ``noise_mode``
    "const" or "none".  Changes ``g`` in place (folded, its parameters
    frozen)."""
    device = resolve_device(device)
    g = g.to(device).eval()
    if not hasattr(g.cfg, "effective_dim_z") \
            and apply_kwargs.get("noise_mode", "random") not in ("const", "none"):
        raise ValueError("a StyleGAN2 sampler exports with noise_mode 'const' or 'none'")
    fold_spectral_norm(g)
    g.requires_grad_(False)
    for m in g.modules():   # each FIR filter's copy on the device, made before the trace
        if isinstance(m, _Filtered):
            m.resample_filter(device)
    args = tuple(torch.zeros(shape, dtype=dt, device=device)
                 for shape, dt in _sampler_signature(g, batch_size))
    program = torch.export.export(_ExportedForward(g, apply_kwargs), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported_sampler(data: bytes) -> Callable:
    """Load an ``export_sampler`` program.  Returns ``sampler(z, label=None,
    feats=None, device_output=False)`` at the exported batch, on the device
    it was exported on; absent conditioning becomes the zero-width
    placeholder.  Images as ``make_sampler`` gives them.  Needs only this
    package's ops, which importing ``ic_gan_tpu_torch.ops`` registers."""
    import ic_gan_tpu_torch.ops  # noqa: F401  (registers the ops the program calls)

    program = torch.export.load(io.BytesIO(data))
    placeholders = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    specs = [placeholders[name] for name in program.graph_signature.user_inputs]
    run = program.module()

    def sampler(z, label=None, feats=None, device_output: bool = False):
        args = [torch.zeros(s.shape, dtype=s.dtype, device=s.device) if a is None
                else torch.as_tensor(a).to(device=s.device, dtype=s.dtype)
                for a, s in zip((z, label, feats), specs)]
        with torch.no_grad():
            out = run(*args)
        return out if device_output else np.ascontiguousarray(out.cpu().numpy())

    sampler.specs, sampler.program = specs, program
    return sampler
