"""Each cell's control, at the cell's own size on the card: the next
precision below the configuration's (the program's int8 serving path for the
sampler, the reference on float8 operands for the train steps) fails at
least one of the cell's limits.  Needs a CUDA card; skips without one:

    python -m pytest portbench/tests/test_portbench_controls.py -m cuda
"""

import pytest
import torch

import harness


def _workloads():
    return [w["name"] for w in harness.load_benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _workloads())
def test_control_fails_a_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    bench = harness.load_benchmark()
    cell = harness.cell(bench, workload)
    mix = harness.traffic(cell["traffic"])
    ctx = dict(cfg=harness.config(bench, cell["config"]), mix=mix, seed=2 ** 31 + 4242,
               seconds=1.0, trace=False, chips=1, device=torch.device("cuda", 0),
               work=harness.work(cell["config"]), workload=workload,
               limits=harness.limits(workload), process_age=harness.process_age)
    checks = harness.driver(mix["driver"]).control(ctx)
    assert not all(c["ok"] for c in checks), checks
