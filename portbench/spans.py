"""What the metrics that read the program's own spans share.  The port
marks its layer boundaries with ``torch.profiler`` ranges
(``ic_gan_tpu_torch/utils/spans.py``), which land in ``Trace.host`` on the
clock of the device activities.  A reader takes the spans of the names it
reads that start inside the sub-window, and returns None where the run holds
none (a program without those spans, or another kind of run)."""

from __future__ import annotations

from readers import _of

# The train steps' spans: ``train/step.py``'s and the four variants of
# ``train/stylegan2_step.py``'s.
STEP_SPANS = ("train_step", "sg2_step/main", "sg2_step/main+pl", "sg2_step/main+r1",
              "sg2_step/main+pl+r1")


def named(tr, names) -> list:
    """``(start_ns, end_ns)`` of the host events called one of ``names``
    that start inside the window, each ended at the window's end at the
    latest."""
    lo, hi = tr.window
    return [(s, min(e, hi)) for n, s, e in tr.host if n in names and lo <= s < hi]


def union(spans) -> list:
    """The union of ``spans``, as sorted disjoint ``[start, end]`` pairs: a
    span inside another counts once, as the outermost."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def ms_per_call(obs: dict, kind: str, names) -> float | None:
    """Host milliseconds inside the spans called one of ``names``
    (outermost only) per call or step of the sub-window."""
    tr = _of(obs, kind, "trace")
    if tr is None or not tr.calls:
        return None
    spans = named(tr, names)
    if not spans:
        return None
    return sum(e - s for s, e in union(spans)) / 1e6 / tr.calls


def idle_inside(obs: dict, kind: str, names) -> float | None:
    """The device's idle time inside the spans called one of ``names``, as
    a percentage of the sub-window; ``device_idle`` less this is the idle
    that falls outside them."""
    tr = _of(obs, kind, "trace")
    if tr is None or tr.window_s <= 0:
        return None
    spans = named(tr, names)
    if not spans:
        return None
    return 100.0 * overlap_ns(union(spans), tr.idle_gaps()) / (tr.window[1] - tr.window[0])
