"""Checkpoints of a train state: port of ``ic_gan_tpu/io/checkpoint.py``.

One checkpoint is one directory, ``<root>/<name>[_<suffix>]/``, holding
``state.pt`` and, when given, ``config.json``.  ``state.pt`` is one
``torch.save`` of a dict by the state's field names: the ``state_dict()`` of
every network and optimizer (``g``, ``d``, ``g_ema``, ``g_opt``, ``d_opt``),
the 0-d tensors (path-length mean, ADA's p and its sign statistic) and the
counts (``step``, ``cur_nimg``).  Any dataclass state of networks,
optimizers, tensors and numbers saves so: ``SG2TrainState`` and the BigGAN
``GANTrainState`` alike.

The save writes ``<tag>.tmp`` and renames it into place, so a crash leaves
the previous checkpoint whole.  Best-copy conventions follow the reference:
``best%d`` suffixes picked by the FID recorded in their config
(``inference/utils.py:285-308``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

STATE_FILE = "state.pt"


def _has_state_dict(v) -> bool:
    return isinstance(v, (nn.Module, torch.optim.Optimizer))


def _path(root: str, name: str, suffix: str) -> str:
    return os.path.join(root, f"{name}_{suffix}" if suffix else name)


def save_checkpoint(root: str, name: str, state: Any, config: Optional[Dict] = None,
                    suffix: str = "") -> str:
    """Atomic save of ``state`` (a dataclass) under ``<root>/<name>[_<suffix>]/``.
    Returns the directory."""
    path = _path(root, name, suffix)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    payload = {}
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        payload[field.name] = v.state_dict() if _has_state_dict(v) else v
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if config is not None:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_checkpoint(root: str, name: str, target: Any, suffix: str = ""):
    """Load into ``target``, a template state of the same structure (its
    networks built, its optimizers made over their parameters), in place and
    on the template's device.  Returns ``(target, config)``; ``config`` is
    None when the checkpoint has none."""
    path = _path(root, name, suffix)
    device = next(target.g.parameters()).device
    # Read to host memory: ``load_state_dict`` then copies each tensor to its
    # parameter's device, and an optimizer keeps its step counts where a
    # fresh one does.
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    names = {f.name for f in dataclasses.fields(target)}
    if set(payload) != names:
        raise KeyError(f"checkpoint {path} holds {sorted(payload)}, the template "
                       f"{sorted(names)}")
    for key, value in payload.items():
        current = getattr(target, key)
        if _has_state_dict(current):
            current.load_state_dict(value)
        elif torch.is_tensor(value):
            setattr(target, key, value.to(device))
        else:
            setattr(target, key, value)
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return target, config


def find_best_checkpoint(root: str, name: str, num_best: int = 2):
    """Among ``best%d`` copies, pick the one whose saved config records the
    lowest FID (mirrors ``inference/utils.py:285-308``)."""
    best_path, best_fid = None, float("inf")
    for i in range(num_best):
        path = os.path.join(root, f"{name}_best{i}")
        cfg_path = os.path.join(path, "config.json")
        if not os.path.exists(cfg_path):
            continue
        with open(cfg_path) as f:
            cfg = json.load(f)
        fid = cfg.get("best_FID", float("inf"))
        if fid < best_fid:
            best_fid, best_path = fid, path
    return best_path, best_fid
