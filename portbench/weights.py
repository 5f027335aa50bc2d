"""Weights from the seed, made by the benchmark and handed to both sides.

A configuration's ``"init"`` lists ``[pattern, rule, value]`` triples
(``fnmatch`` patterns over state-dict keys; the first that matches wins):
``"const"`` fills ``value``, ``"normal"`` draws N(0, value²) and
``"normal_fan_in"`` N(0, value² / fan_in), fan_in being the product of the
leaf's trailing dimensions.  Every normal draw comes from one call on the
device with a ``torch.Generator`` seeded from the run's seed, so the state
is made in a few large calls, in the order of its sorted keys.

The keys are the plain reference's: a driver builds the reference's model on
the ``meta`` device, draws its state once, and both sides load it by name
(``materialize``), so that a leaf the program adds or drops shifts no draw.
A model is built on ``meta`` and loads this state, so neither side's own
initializer runs.
"""

from __future__ import annotations

import fnmatch
import math

import numpy as np
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from the run's seed and ``keys``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _rule(key: str, rules):
    for pattern, kind, value in rules:
        if fnmatch.fnmatchcase(key, pattern):
            return kind, value
    raise KeyError(f"no init rule matches {key!r}")


def make_state(shapes: dict, rules, seed: int, device) -> dict:
    """``{key: tensor}`` for ``shapes`` (``{key: (shape, dtype)}``), float32
    leaves made by ``rules`` from ``seed``; other dtypes take a ``"const"``
    rule."""
    keys = sorted(shapes)
    plan = {k: _rule(k, rules) for k in keys}
    normal = [k for k in keys if plan[k][0] in ("normal", "normal_fan_in")]
    total = sum(math.prod(shapes[k][0]) for k in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for k in keys:
        shape, dtype = shapes[k]
        kind, value = plan[k]
        if kind == "const":
            out[k] = torch.full(shape, value, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        scale = value / math.sqrt(math.prod(shape[1:]) or 1) if kind == "normal_fan_in" \
            else value
        out[k] = (flat[at:at + n] * scale).reshape(shape).to(dtype)
        at += n
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


def materialize(module: torch.nn.Module, state: dict, device, rules=(),
                seed: int = 0) -> torch.nn.Module:
    """A module built on ``meta`` put on ``device`` holding ``state``, each
    leaf loaded by its name (and cast to the module's type).  A leaf of the
    module that ``state`` lacks is drawn by ``rules`` from a seed of its own
    (derived from ``seed``), after the others, so it moves none of their
    values; a leaf of ``state`` that the module lacks is not loaded."""
    module = module.to_empty(device=device)
    own = shapes_of(module)
    full = {k: v for k, v in state.items() if k in own}
    extra = {k: v for k, v in own.items() if k not in state}
    if extra:
        full.update(make_state(extra, rules, sub_seed(seed, 1), device))
    module.load_state_dict(full, strict=True)
    return module
