"""CPU tests of the benchmark (``python -m pytest portbench/tests``).  The
harness's modules import from ``portbench/`` and the program from the root
of the checkout, as ``run.py`` arranges."""

import json
import sys
from pathlib import Path

import pytest
import torch

PB = Path(__file__).resolve().parent.parent
for p in (str(PB), str(PB.parent)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(PB) else 1, p)

import harness  # noqa: E402

TOY_MODEL = {
    "icgan_biggan_res256": dict(resolution=32, G_ch=4, D_ch=4, G_attn="16", D_attn="16",
                                instance_sz=16, shared_dim_feat=8, shared_dim=8, dim_z=20),
    "icgan_sg2ada_res256": dict(img_resolution=32, z_dim=32, h_dim=16, w_dim=32,
                                channel_base=256, channel_max=32, num_fp16_res=2),
}
TOY_MIX = {
    "sample": dict(batch=8, request_rows=8, pool_requests=32, bank_rows=64,
                   keep_candidates=8, trace_calls=2, control_requests=2),
    "biggan_train": dict(microbatch=4, pool_images=16, bank_rows=64, log_every=2,
                         trace_steps=1),
    "sg2_train": dict(microbatch=4, pool_images=16, bank_rows=64, log_every=2,
                      trace_steps=4),
}


def toy_ctx(workload: str, seed: int = 2 ** 31 + 77, seconds: float = 0.3,
            trace: bool = False, limits=None, dtype_f32: bool = False) -> dict:
    """A run's context for ``workload`` at a toy size on the CPU: the
    harness's look for a chip is skipped, the rest is the run's."""
    bench = harness.load_benchmark()
    cell = harness.cell(bench, workload)
    cfg = json.loads(json.dumps(harness.config(bench, cell["config"])))
    cfg["model"].update(TOY_MODEL[cell["config"]])
    mix = dict(harness.traffic(cell["traffic"]))
    mix.update(TOY_MIX[mix["driver"]])
    return dict(cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace, chips=1,
                device=torch.device("cpu"), work=harness.work(cell["config"]),
                workload=workload, limits=limits or harness.limits(workload),
                process_age=harness.process_age)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
