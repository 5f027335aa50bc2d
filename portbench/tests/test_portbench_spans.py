"""The readers of the program's spans (``spans.py`` and the metrics that use
it) on synthetic traces with hand-worked spans, gaps and calls."""

import pytest

import harness
from spans import overlap_ns, union
from tracing import WINDOW, Trace

# Device busy 0-150, 250-450, 700-1000 ns: idle 150-250 and 450-700.
DEVICE = [("k0", 0, 150), ("k1", 250, 450), ("k2", 700, 1000)]


def _train_trace(calls=2):
    host = [(WINDOW, 0, 1000),
            ("train_step", -50, 50),           # starts before the window: left out
            ("data/normalize_batch", 40, 90),
            ("train_step", 100, 400),
            ("train_step", 120, 380),          # nested in the one above: counted once
            ("phase/D", 110, 200),
            ("data/normalize_batch", 420, 480),
            ("sg2_step/main+pl", 500, 800),
            ("data/ada_pipe", 520, 560),
            ("data/ada_pipe", 600, 650),
            ("aten::add", 610, 620)]
    return Trace(device=list(DEVICE), host=host, window=(0, 1000), calls=calls)


def _sample_trace():
    host = [(WINDOW, 0, 1000), ("sampler/call", 100, 300), ("sampler/call", 400, 650)]
    return Trace(device=list(DEVICE), host=host, window=(0, 1000), calls=2)


def _read(metric, obs):
    return harness.reader(metric).read(obs)


def test_union_and_overlap():
    assert union([(5, 9), (0, 3), (1, 2), (3, 4)]) == [[0, 4], [5, 9]]
    assert overlap_ns([[100, 400], [500, 800]], [(150, 250), (450, 700)]) == 300
    assert overlap_ns([[0, 10]], [(10, 20)]) == 0
    assert overlap_ns([], [(0, 5)]) == 0


def test_train_span_readers():
    obs = dict(kind="train", trace=_train_trace())
    # Steps: 100-400 (its nested copy and the one before the window left
    # out) and 500-800, over 2 steps.
    assert _read("host_ms.train", obs) == pytest.approx(600e-6 / 2)
    # Idle 150-250 lies inside the first step; of 450-700 only 500-700 lies
    # inside the second: 300 ns of the 1000 ns window.
    assert _read("idle_in_step.train", obs) == pytest.approx(30.0)
    assert _read("idle_in_step.train", obs) <= _read("device_idle.train", obs) == 35.0
    assert _read("data_ms.train", obs) == pytest.approx(110e-6 / 2)
    assert _read("ada_ms.train", obs) == pytest.approx(90e-6 / 2)
    for m in ("host_ms.sample", "idle_in_call.sample"):
        assert _read(m, obs) is None                 # another kind of run


def test_sample_span_readers():
    obs = dict(kind="sample", trace=_sample_trace())
    assert _read("host_ms.sample", obs) == pytest.approx(450e-6 / 2)
    # 150-250 inside the first call, 450-650 of the gap 450-700 inside the second.
    assert _read("idle_in_call.sample", obs) == pytest.approx(30.0)
    assert _read("idle_in_call.sample", obs) <= _read("device_idle.sample", obs)


@pytest.mark.parametrize("metric,kind", [
    ("host_ms.sample", "sample"), ("idle_in_call.sample", "sample"),
    ("host_ms.train", "train"), ("idle_in_step.train", "train"),
    ("data_ms.train", "train"), ("ada_ms.train", "train")])
def test_no_span_no_reading(metric, kind):
    """A program without the spans (the parent's), an untraced run and a
    sub-window of no calls read nothing."""
    bare = Trace(device=list(DEVICE), host=[(WINDOW, 0, 1000), ("aten::mm", 10, 20)],
                 window=(0, 1000), calls=2)
    assert _read(metric, dict(kind=kind, trace=bare)) is None
    assert _read(metric, dict(kind=kind)) is None
    full = _sample_trace() if kind == "sample" else _train_trace()
    assert _read(metric, dict(kind=kind, trace=full)) is not None
    if metric.split(".")[0].endswith("_ms"):
        full.calls = 0
        assert _read(metric, dict(kind=kind, trace=full)) is None


def test_breakdown_names_a_gap_inside_a_step_by_its_span():
    gaps = dict((round(t * 1e9), name) for name, t in _train_trace().breakdown()["idle_gaps"])
    assert gaps == {100: "phase/D", 250: "data/normalize_batch"}
