"""The benchmark's data-driven parts: finding a cell's configuration,
traffic mix, driver, work counts and metric readers by the names in
``BENCHMARK.json``, and the checks every run makes around the program.

Layout under ``portbench/`` (a new cell, configuration, mix or metric is new
files plus new entries in ``BENCHMARK.json``; no file here changes):

- ``configs/<config>.json``: the model's sizes as run, its weight rules;
- ``traffic/<mix>.json``: the mix's parameters; ``"driver"`` names the
  general generator in ``drivers/<driver>.py`` that reads them;
- ``limits/<workload>.json``: the limits of the cell's compared numbers;
- ``work/<config>.py``: operations and bytes from the configuration's widths;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` → a number
  or None (nothing to read in this run).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent
# Whole top-level module names that no run may hold once its window has
# closed: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "ic_gan_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    return name


def cell(bench: dict, workload: str) -> dict:
    return _named(bench["workloads"], _checked(workload), "workload")


def config(bench: dict, name: str) -> dict:
    entry = _named(bench["configs"], _checked(name), "config")
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(PB / "traffic" / f"{_checked(name)}.json") as f:
        return json.load(f)


def limits(workload: str) -> dict:
    """The cell's limits for the numbers that decide ``correct``, each set
    from a lower and an upper reading (``PERF.md``)."""
    with open(PB / "limits" / f"{_checked(workload)}.json") as f:
        return json.load(f)


def _load(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + re.sub(r"\W", "_", name)


def driver(name: str):
    return _load(PB / "drivers" / f"{_checked(name)}.py", _modname("driver", name))


def work(config_name: str):
    return _load(PB / "work" / f"{_checked(config_name)}.py", _modname("work", config_name))


def reader(metric: str):
    return _load(PB / "metrics" / f"{_checked(metric)}.py", _modname("metric", metric))


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` prints: the cell's end-to-end
    metrics, or with ``trace`` its per-layer ones: those that list the cell,
    and those without a list that move an end-to-end metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (both readings on
    the boot clock, clock-tick resolution), so that the interpreter's own
    start-up counts in ``setup_s``."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> list:
    """Top-level module names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``ic_gan_tpu_torch`` is not ``ic_gan_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that the first run of a cell builds and later ones hit.  The port builds
    its CUDA kernels into ``ic_gan_tpu_torch/build/`` of the checkout."""
    base = PB / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
