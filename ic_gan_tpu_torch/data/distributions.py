"""Conditioning distributions: port of ``ic_gan_tpu/data/distributions.py``
(reference ``Distribution`` and ``prepare_z_y``/``sample_conditioning_values``,
``data_utils/utils.py:830-1026``).

``NoiseDist`` and ``ClassDist`` are samplers over a ``torch.Generator`` (the
JAX package's take keys).  ``sample_gen_labels`` and
``make_weights_for_balanced_classes`` are host-side numpy, the JAX
package's own code, so they draw what it draws from the same
``np.random.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseDist:
    """z ~ N(0, var · I), shape (batch, dim_z) (ref ``normal`` dist)."""

    dim_z: int
    var: float = 1.0

    def sample(self, generator: Optional[torch.Generator], batch: int, device=None):
        return torch.randn((batch, self.dim_z), generator=generator, device=device) \
            * float(np.sqrt(self.var))


@dataclasses.dataclass(frozen=True)
class ClassDist:
    """Class-label distribution: uniform categorical, long-tail empirical, or
    temperature-annealed long-tail (ref ``categorical[_longtail[_temperature]]``,
    ``utils.py:975-1016``)."""

    num_classes: int
    class_prob: Optional[np.ndarray] = None  # empirical p(c) (ImageNet-LT)
    temperature: Optional[float] = None

    def probs(self) -> Optional[np.ndarray]:
        if self.class_prob is None:
            return None
        p = np.asarray(self.class_prob, dtype=np.float64)
        if self.temperature is not None:
            p = np.exp(np.log(p) / self.temperature)
            p = p / p.sum()
        return p

    def sample(self, generator: Optional[torch.Generator], batch: int, device=None):
        p = self.probs()
        if p is None:
            return torch.randint(0, self.num_classes, (batch,), generator=generator,
                                 device=device)
        return torch.multinomial(torch.as_tensor(p, device=device), batch, replacement=True,
                                 generator=generator)


def prepare_z_y(
    dim_z: int,
    n_classes: int,
    z_var: float = 1.0,
    longtail_gen: bool = False,
    custom_distrib: bool = False,
    longtail_temperature: float = 1.0,
    class_probabilities=None,
):
    """The (z, y) samplers with the reference's dispatch (``prepare_z_y``,
    ``utils.py:904-973``)."""
    z = NoiseDist(dim_z=dim_z, var=z_var)
    if longtail_gen:
        y = ClassDist(n_classes, class_prob=class_probabilities)
    elif custom_distrib:
        y = ClassDist(n_classes, class_prob=class_probabilities,
                      temperature=longtail_temperature)
    else:
        y = ClassDist(n_classes)
    return z, y


def sample_gen_labels(
    rng: np.random.Generator,
    n: int,
    n_classes: int,
    longtail_gen: bool = False,
    custom_distrib_gen: bool = False,
    longtail_temperature: float = 1.0,
    constant_conditioning: bool = False,
    class_prob=None,
) -> np.ndarray:
    """Host-side generator-label draw for class-conditional models without
    instance features, the y distribution of ``sample_conditioning_values``
    (ref ``utils.py:879-890`` + ``prepare_z_y`` dispatch ``:904-1016``):
    uniform, empirical long-tail (``longtail_gen``), temperature-annealed
    softmax(log p / T) (``custom_distrib_gen``), or all zeros
    (``constant_conditioning``)."""
    if constant_conditioning:
        return np.zeros(n, np.int64)
    if longtail_gen or custom_distrib_gen:
        p = np.asarray(class_prob, np.float64).reshape(-1)
        p = p / p.sum()
        if custom_distrib_gen:
            logp = np.log(np.maximum(p, 1e-300))
            p = np.exp(logp / longtail_temperature)
            p = p / p.sum()
        return rng.choice(n_classes, n, replace=True, p=p).astype(np.int64)
    return rng.integers(0, n_classes, size=n).astype(np.int64)


def make_weights_for_balanced_classes(
    labels: np.ndarray,
    n_classes: int,
    longtail_temperature: float = 1.0,
) -> np.ndarray:
    """Per-sample weights that re-balance a long-tail dataset with a
    temperature-annealed class distribution (ref ``utils.py:227-287``):
    weight(sample) = softmax(log p(c) / T)[c] / count(c)."""
    labels = np.asarray(labels)
    count = np.bincount(labels, minlength=n_classes).astype(np.float64)
    class_prob = count / count.sum()
    logp = np.log(class_prob, out=np.full_like(class_prob, -np.inf),
                  where=class_prob > 0)
    tempered = np.exp(logp / longtail_temperature)
    tempered = tempered / tempered.sum()
    per_class = np.zeros(n_classes)
    nz = count > 0
    per_class[nz] = tempered[nz] / count[nz]
    return per_class[labels]
