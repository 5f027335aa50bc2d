"""Training loggers: the port's copy of ``ic_gan_tpu/utils/logging.py``
(reference ``BigGAN_PyTorch/utils.py:1272-1345``).

``MetricsLogger`` — one JSONL line per call with a ``_stamp`` field.
``MetricLogger``  — one plaintext ``.log`` file per metric (MATLAB-friendly),
the reference's ``MyLogger``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, fname: str, reinitialize: bool = False):
        self.fname = fname
        if os.path.exists(fname) and reinitialize:
            os.rename(fname, fname + ".bak")

    def log(self, record: Dict[str, Any] = None, **kwargs):
        record = dict(record or {})
        record.update(kwargs)
        record["_stamp"] = time.time()
        with open(self.fname, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


class MetricLogger:
    """Per-metric plaintext logs: ``<root>/<metric>.log`` with ``itr: value``
    lines (ref ``MyLogger``, ``utils.py:1299-1337``)."""

    def __init__(self, root: str, reinitialize: bool = False, logstyle: str = "%3.3f"):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.reinitialize = reinitialize
        self.metrics = []
        self.logstyle = logstyle

    def _reinit(self, item):
        path = os.path.join(self.root, f"{item}.log")
        if os.path.exists(path) and self.reinitialize:
            os.rename(path, path + ".bak")

    def log(self, itr: int, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            if k not in self.metrics:
                self._reinit(k)
                self.metrics.append(k)
            with open(os.path.join(self.root, f"{k}.log"), "a") as f:
                f.write(f"{itr}: {self.logstyle % float(v)}\n")


def write_metadata(logs_root: str, experiment_name: str, config: Dict[str, Any]):
    """Dump the config next to the logs (ref ``utils.py:1341-1345``)."""
    os.makedirs(logs_root, exist_ok=True)
    with open(os.path.join(logs_root, f"{experiment_name}_metadata.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
