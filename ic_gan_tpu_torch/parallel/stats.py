"""Training statistics as (num, Σ, Σ²) moments: port of
``ic_gan_tpu/parallel/stats.py`` (reference ``torch_utils/training_stats.py``).

``report`` adds a value's moments to a dict carried through a step; the
host-side ``Collector`` accumulates them across steps and reports mean and
std.  The JAX package's moments are global because its arrays are; here
each rank reports its own share, and ``Collector.update`` sums the moments
over the ranks when a process group is up.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ic_gan_tpu_torch.parallel.collectives import all_reduce
from ic_gan_tpu_torch.parallel.mesh import Mesh


def report(stats: Dict[str, torch.Tensor], name: str, value) -> Dict:
    """``stats`` with ``name``'s (num, Σ, Σ²) moments of ``value`` (float32)
    added; a new dict."""
    value = torch.as_tensor(value).to(torch.float32).reshape(-1)
    moments = torch.stack([torch.tensor(float(value.numel()), device=value.device),
                           value.sum(), value.square().sum()])
    new = dict(stats)
    new[name] = new[name] + moments if name in new else moments
    return new


class Collector:
    """Host-side accumulator with regex subscription (ref ``Collector``).
    With a process group up, each ``update`` sums the subscribed moments
    over its ranks, on the moments' device (every rank calls it with the
    same names)."""

    def __init__(self, regex: str = ".*"):
        self.pattern = re.compile(regex)
        self.moments: Dict[str, np.ndarray] = {}

    def update(self, stats: Dict[str, torch.Tensor]):
        names = [n for n in stats if self.pattern.fullmatch(n)]
        if not names:
            return
        vals = [torch.as_tensor(stats[n]) for n in names]
        if dist.is_initialized():
            mesh = Mesh(None, dist.get_world_size(), dist.get_rank(), vals[0].device)
            stacked = torch.stack([v.to(mesh.device, torch.float64) for v in vals])
            vals = list(all_reduce(stacked, mesh))
        for name, m in zip(names, vals):
            m = m.detach().cpu().numpy().astype(np.float64)
            self.moments[name] = self.moments[name] + m if name in self.moments else m

    def num(self, name: str) -> float:
        return float(self.moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self.moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self.moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean ** 2, 0.0)
        return float(np.sqrt(var))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name), "std": self.std(name)}
                for name in self.moments}

    def reset(self):
        self.moments = {}
