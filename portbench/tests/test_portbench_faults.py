"""Each cell's run, its look for a chip skipped, at a toy size on the CPU in
float32: a sound run is correct against the plain reference under the cell's
limits, and a run whose timed path is broken underneath (``faults.py``) is
not, once for each fault the cell can have."""

import pytest

import harness
from conftest import toy_ctx
from faults import FAULTS, planted


def _f32(ctx):
    cfg = ctx["cfg"]
    if "sample" in cfg:
        cfg["sample"].update(weights="float32", compute="float32")
    if cfg["backbone"] == "biggan":
        cfg["train"]["compute"] = "float32"
    else:
        cfg["model"]["num_fp16_res"] = 0
    return ctx


def _cells():
    return [w["name"] for w in harness.load_benchmark()["workloads"] if w["chips"] == 1]


def _run(workload):
    ctx = _f32(toy_ctx(workload))
    return ctx["mix"]["driver"], harness.driver(ctx["mix"]["driver"]), ctx


@pytest.mark.parametrize("workload", _cells())
def test_sound_run_is_correct(workload):
    _, drv, ctx = _run(workload)
    out = drv.run(ctx)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in _cells()
    for f in FAULTS[harness.traffic(harness.cell(harness.load_benchmark(), w)["traffic"])
                    ["driver"]]])
def test_broken_run_is_not_correct(workload, fault):
    name, drv, ctx = _run(workload)
    with planted(name, fault):
        out = drv.run(ctx)
    assert not out["correct"], out["checks"]
