"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, traffic mix and metrics by name (``harness.py``), and hands
them to the mix's driver, which builds the program (``ic_gan_tpu_torch``)
with weights from the seed, warms up every shape the cell uses, measures for
``--seconds``, and judges what the timed path produced against the plain
reference (``reference/``).  With ``--trace 1`` the run prints the per-layer
metrics, read from a stretch timed by the host and a profiled sub-window.
The last line of standard output is one JSON object; the numbers compared
for ``correct`` are printed last on standard error and last in that line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import harness
import peaks


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 1


def result_line(out: dict, metrics: list, chips: int) -> dict:
    import torch

    values = {}
    for m in metrics:
        v = harness.reader(m["name"]).read(out["obs"])
        if v is not None:
            if not math.isfinite(v):
                raise ValueError(f"metric {m['name']} read {v}")
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": values, "device": device}
    tr = out["obs"].get("trace")
    if tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out["checks"]}
    return line


def main(argv) -> int:
    args = parse(argv)
    sys.path.insert(1, str(harness.ROOT))   # the program, from the checkout's root
    harness.cache_env()
    try:
        bench = harness.load_benchmark()
        cell = harness.cell(bench, args.workload)
        cfg = harness.config(bench, cell["config"])
        mix = harness.traffic(cell["traffic"])
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot read the cell: {e}")
    metrics = harness.cell_metrics(bench, args.workload, bool(args.trace))

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return fail(f"the cell needs {chips} CUDA device(s), found {n}")

    drv = harness.driver(mix["driver"])
    ctx = dict(cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds,
               trace=bool(args.trace), chips=chips, device=torch.device("cuda", 0),
               work=harness.work(cell["config"]), workload=args.workload,
               limits=harness.limits(args.workload), process_age=harness.process_age)
    print(peaks.card_line(), file=sys.stderr)
    out = drv.run(ctx)

    found = harness.forbidden_loaded()
    if found:
        return fail("the process holds JAX or the JAX package: " + ", ".join(found))
    if out is None:   # a rank other than the first prints nothing
        return 0
    line = result_line(out, metrics, chips)
    print(f"reference and comparison after the window: {out['reference_s']:.2f} s",
          file=sys.stderr)
    for c in out["checks"]:
        where = f", worst at {c['where']}" if c.get("where") else ""
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
              f"{'ok' if c['ok'] else 'FAILED'}{where})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
