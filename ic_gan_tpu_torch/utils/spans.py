"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs in this thread (autograd's worker threads see the caller's
profiler), and otherwise one shared no-op context: with no profiler a span
costs a flag check, where an open range costs about a hundred times that.
The ranges are the profiler's own host events, on the same clock as the
device activities of its trace.

| span | layer | bounds |
| --- | --- | --- |
| ``sampler/call`` | sampler | one request through ``io.deploy.make_sampler``'s sampler: its batches, the pad and the concatenation |
| ``train_step`` | train step | one BigGAN step of ``train.step.make_train_step`` |
| ``sg2_step/<variant>`` | train step | one StyleGAN2 step of ``train.stylegan2_step.make_sg2_train_step``; ``main``, ``main+pl``, ``main+r1`` or ``main+pl+r1`` |
| ``phase/D``, ``phase/G``, ``phase/ema`` | train step | a step's D phase, G phase (each with its optimizer step) and EMA update, in both steps |
| ``data/normalize_batch`` | data | ``data.loader.normalize_batch``, the copy to the device included |
| ``data/ada_pipe`` | data | one call of ``data.ada.AugmentPipe`` |
| ``bias_act_bwd`` | kernels | ``ops.bias_act.BiasAct.backward`` |
"""

from __future__ import annotations

import contextlib

import torch

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context that marks its block as ``name`` in a running profiler's
    trace, and does nothing when none runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOOP
