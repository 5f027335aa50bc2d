"""Run-wide settings for the test suite under pytest-xdist.

``tests/conftest.py`` sets up each process's JAX backend; this file, which
pytest loads before it, shares the machine among the xdist workers of one run:

- each worker is pinned to its own window of the cores, so that its XLA and
  torch thread pools are sized to a share of the machine and not to all of it;
- the run's workers share one JAX compilation cache, so that a program that
  several tests or files build is compiled once; the run removes it at its end;
- every test runs under a time limit of its own (``tests/time_limit.py``).

JAX is configured through its environment variables: this file is loaded by
any pytest run in the repo, also where JAX is not installed.
"""

import contextlib
import os
import shutil
import tempfile
import time
import uuid

pytest_plugins = ["tests.time_limit"]


def _share_the_cores():
    """Pin an xdist worker to its own window of the cores.

    A window is twice a worker's even share, so that the cores a neighbour
    leaves idle are not lost; its threads, and those of the processes a test
    starts, stay inside it.
    """
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if workers < 2 or not worker.startswith("gw"):
        return
    cores = sorted(os.sched_getaffinity(0))
    width = min(len(cores), -(-2 * len(cores) // workers))
    first = int(worker[2:]) * len(cores) // workers
    os.sched_setaffinity(
        0, {cores[(first + i) % len(cores)] for i in range(width)})


if hasattr(os, "sched_setaffinity"):
    _share_the_cores()

# The cache is made by the run's first process (the xdist controller, or the
# lone process), whose environment the workers inherit, and is removed by it
# at the end of the run. Every compile is stored.
_CACHE_PREFIX = "ic_gan_tests_xla_"
# A run ends within its time limit, so a cache older than this is a leftover
# of a run that was killed before it could remove it.
_STALE_SECONDS = 4 * 3600
_run_cache = None
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    _run_cache = os.path.join(
        tempfile.gettempdir(), _CACHE_PREFIX + uuid.uuid4().hex)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _run_cache
    os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"


def _remove_stale_caches():
    root = tempfile.gettempdir()
    for name in os.listdir(root):
        path = os.path.join(root, name)
        with contextlib.suppress(OSError):  # another run removed it first
            if (name.startswith(_CACHE_PREFIX)
                    and time.time() - os.path.getmtime(path) > _STALE_SECONDS):
                shutil.rmtree(path, ignore_errors=True)


def pytest_configure(config):
    if _run_cache:
        _remove_stale_caches()


def pytest_unconfigure(config):
    if _run_cache:
        shutil.rmtree(_run_cache, ignore_errors=True)
