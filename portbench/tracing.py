"""The traced run's sub-window: ``torch.profiler`` over a bounded number of
calls, reduced in memory to device intervals and host operations.

Only ``--trace 1`` runs profile.  The sub-window is a ``record_function``
range named ``WINDOW`` that ends after a device synchronize, so its length
on the trace's own clock is the window; device time is the union of every
device activity's interval (kernels, copies, sets) inside it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from kernels import kernel_class

WINDOW = "portbench.window"


@dataclass
class Trace:
    """Device activities ``(name, start_ns, end_ns)``, host operations
    ``(name, start_ns, end_ns)`` and the window ``(start_ns, end_ns)``."""

    device: list
    host: list
    window: tuple
    calls: int = 0           # sampler calls or train steps in the window
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of device intervals, clipped to the window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, match) -> float:
        """Seconds of the device activities whose name ``match`` accepts."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device
                   if e > lo and s < hi and match(n)) / 1e9

    def count(self, match=lambda n: True) -> int:
        lo, hi = self.window
        return sum(1 for n, s, e in self.device if lo <= s < hi and match(n))

    def idle_gaps(self) -> list:
        """``(start_ns, end_ns)`` of every stretch of the window with no
        device activity."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_op_at(self, t_ns: int) -> str:
        """The innermost host operation running at ``t_ns``, or "idle"."""
        best = None
        for n, s, e in self.host:
            if s <= t_ns < e and n != WINDOW and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "host idle"

    def breakdown(self, top: int = 10) -> dict:
        """The device classes that took most time, and the longest idle
        gaps named by what the host was doing, in seconds."""
        lo, hi = self.window
        by_class = {}
        for n, s, e in self.device:
            if e > lo and s < hi:
                c = kernel_class(n)
                by_class[c] = by_class.get(c, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
        ops = sorted(by_class.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[c, t] for c, t in ops],
                "idle_gaps": [[self.host_op_at(s), (e - s) / 1e9] for s, e in gaps]}


def sync(device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(sync):
    """Profile the block as one window; yields a dict that holds the
    ``Trace`` under ``"trace"`` once the block has ended.  ``sync`` waits for
    the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            sync()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.name() != WINDOW and not e.is_user_annotation():   # not a range's shadow
                device.append(span)
        elif e.name() == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    out["trace"] = Trace(device=device, host=host, window=window)
