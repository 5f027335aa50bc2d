"""What the per-layer metric readers share.  Each reader in ``metrics/``
calls one of these with the kind of run it reads (``"sample"`` or
``"train"``), and returns None where the run holds nothing to read."""

from __future__ import annotations

import re

_COPIES = ("Memcpy", "Memset")


def _of(obs: dict, kind: str, key: str):
    return obs.get(key) if obs.get("kind") == kind else None


def launches(obs: dict, kind: str):
    """Device kernels in the profiled sub-window per call or step (copies
    and sets are not launches of a kernel)."""
    tr = _of(obs, kind, "trace")
    if tr is None or not tr.calls:
        return None
    return tr.count(lambda n: not n.startswith(_COPIES)) / tr.calls


def mfu(obs: dict, kind: str):
    """Model operations of the host-timed stretch over its time, as a
    percentage of the chips' bf16 peak."""
    rate = _of(obs, kind, "rate")
    if rate is None or rate["seconds"] <= 0:
        return None
    return 100.0 * rate["flops"] / rate["seconds"] / (obs["chips"] * rate["peak"])


def device_idle(obs: dict, kind: str):
    tr = _of(obs, kind, "trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def peak_gib(obs: dict, kind: str):
    if obs.get("kind") != kind or "peak_bytes" not in obs or obs["peak_bytes"] <= 0:
        return None
    return obs["peak_bytes"] / 2 ** 30


def roofline(obs: dict, kind: str, pattern: str, work_key: str, cost):
    """The least time of the work in ``trace.extra[work_key]`` (each entry
    costed by ``cost``) over the device time of the kernels whose names
    match ``pattern``, as a percentage; None where no kernel matches."""
    tr = _of(obs, kind, "trace")
    if tr is None or not tr.extra.get(work_key):
        return None
    rx = re.compile(pattern)
    device = tr.device_s(lambda n: rx.search(n) is not None)
    if device <= 0:
        return None
    return 100.0 * sum(cost(w) for w in tr.extra[work_key]) / device
