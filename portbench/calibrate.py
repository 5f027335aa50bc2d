"""Readings that the limits of ``correct`` are set from (``PERF.md``).

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault NAME --fault-seeds 1,2,3] [--seconds 2] [--out FILE]

In one process (the kernels are built once): for each of ``--seeds`` a short
run of the cell's timed path, judged as a full run is (the lower readings);
for each of ``--control-seeds`` the cell's control, the next precision below
the configuration's, judged alike (the upper readings); for each of
``--fault-seeds`` a run with ``--fault`` planted under the timed path
(``faults.py``).  Every number the driver can compare is read, whether or
not the cell's limits name it.  Prints one JSON
line per reading, and appends it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import faults
import harness


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(1, str(harness.ROOT))
    harness.cache_env()
    import torch

    bench = harness.load_benchmark()
    cell = harness.cell(bench, args.workload)
    mix = harness.traffic(cell["traffic"])
    drv = harness.driver(mix["driver"])

    def ctx(seed):
        return dict(cfg=harness.config(bench, cell["config"]), mix=mix, seed=seed,
                    seconds=args.seconds, trace=False, chips=int(cell["chips"]),
                    device=torch.device("cuda", 0), work=harness.work(cell["config"]),
                    workload=args.workload, limits=None, process_age=harness.process_age)

    def emit(kind, seed, checks, t0):
        rec = dict(workload=args.workload, kind=kind, seed=seed, seconds=time.time() - t0,
                   card=torch.cuda.get_device_name(0),
                   checks={c["name"]: c["value"] for c in checks},
                   where={c["name"]: c["where"] for c in checks if c.get("where")})
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        (f"fault:{args.fault}", args.fault_seeds)):
        for s in filter(None, seeds.split(",")):
            t0 = time.time()
            if kind == "control":
                checks = drv.control(ctx(int(s)))
            else:
                with faults.planted(mix["driver"], args.fault) if args.fault and \
                        kind != "program" else contextlib.nullcontext():
                    checks = drv.run(ctx(int(s)))["checks"]
            emit(kind, int(s), checks, t0)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
