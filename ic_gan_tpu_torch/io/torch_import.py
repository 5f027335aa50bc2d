"""Reference ``.pth`` checkpoints into the port: port of the loaders of
``ic_gan_tpu/io/torch_import.py``.

The reference saves one ``.pth`` per module (``G.pth``, ``G_ema.pth``,
``D.pth``, their optimizers) and ``state_dict.pth`` holding the run's config
and scores, with ``_<suffix>`` for its ``best%d``/``copy%d`` copies
(``BigGAN_PyTorch/utils.py:1116-1167``).  The port's modules carry the
upstream names, BigGAN-deep's included, so a bundle loads into them as it
is: no key map, no transposes.  Only the ``accum_counter`` buffers
(standing statistics, the port's own) have no counterpart there; a load
sets them to zero.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import torch
from torch.nn.utils import skip_init

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.models.biggan import BigGANConfig
from ic_gan_tpu_torch.models.biggan_deep import model_classes


def config_from_state_dict(state_dict_config: Dict[str, Any]) -> BigGANConfig:
    """A BigGAN config from the reference's saved config blob (the
    ``config`` entry of ``state_dict.pth``), with its defaults where a key
    is absent (``inference/utils.py:311-368``).  A BigGAN-deep blob raises:
    its geometry needs the caller's config (``cli.config.split_config``)."""
    c = state_dict_config
    if c.get("model", "BigGAN") == "BigGANdeep":
        raise ValueError(
            "the bundle's config names model: BigGANdeep; pass its model config as "
            "cfg (cli.config.split_config of the run's flags builds a BigGANDeepConfig)")
    return BigGANConfig(
        resolution=c.get("resolution", 128),
        n_classes=c.get("n_classes", 1000),
        G_ch=c.get("G_ch", 96),
        D_ch=c.get("D_ch", 96),
        dim_z=c.get("dim_z", 120),
        bottom_width=c.get("bottom_width", 4),
        G_attn=str(c.get("G_attn", "64")),
        D_attn=str(c.get("D_attn", "64")),
        G_shared=c.get("G_shared", True),
        shared_dim=c.get("shared_dim", 128),
        hier=c.get("hier", True),
        class_cond=c.get("class_cond", True),
        instance_cond=c.get("instance_cond", False),
        G_shared_feat=c.get("G_shared_feat", True),
        shared_dim_feat=c.get("shared_dim_feat", 2048),
        SN_eps=c.get("SN_eps", 1e-6),
        BN_eps=c.get("BN_eps", 1e-5),
    )


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def select_best_pth_suffix(weights_dir: str, num_best: int = 2) -> str:
    """The ``best%d`` copy whose ``state_dict_best%d.pth`` records the lowest
    FID (``inference/utils.py:285-308``); "" when there is none."""
    best, best_fid = "", float("inf")
    for i in range(num_best):
        path = os.path.join(weights_dir, f"state_dict_best{i}.pth")
        if not os.path.exists(path):
            continue
        fid = float(_load(path).get("best_FID", float("inf")))
        if fid < best_fid:
            best_fid, best = fid, f"best{i}"
    return best


def load_pth_bundle(weights_dir: str, name: str = "G_ema", suffix: str = "") -> Dict[str, Any]:
    """One ``<name>[_<suffix>].pth`` of a reference checkpoint directory, as
    saved (a state dict of CPU tensors)."""
    fname = f"{name}{('_' + suffix) if suffix else ''}.pth"
    return _load(os.path.join(weights_dir, fname))


def _load_module(kind: str, weights_dir: str, name: str, suffix: str, cfg, device,
                 strict: bool):
    if cfg is None:
        sd_name = f"state_dict{('_' + suffix) if suffix else ''}.pth"
        cfg = config_from_state_dict(_load(os.path.join(weights_dir, sd_name))["config"])
    return _module_from_state_dict(kind, load_pth_bundle(weights_dir, name, suffix), cfg,
                                   device, strict, f"{name} bundle")


def _module_from_state_dict(kind: str, state_dict, cfg, device, strict: bool, what: str):
    cls = model_classes(cfg)[kind == "D"]
    net = skip_init(cls, cfg, device=resolve_device(device))
    result = net.load_state_dict(state_dict, strict=False)
    missing = []
    for key in result.missing_keys:
        if key.endswith("accum_counter"):
            net.get_buffer(key).zero_()
        else:
            missing.append(key)
    unexpected = list(result.unexpected_keys)
    if strict and (missing or unexpected):
        raise KeyError(f"{what}: missing {missing[:10]}, unexpected {unexpected[:10]}")
    return net, missing, unexpected


def load_generator_state_dict(state_dict, cfg, device=None, strict: bool = True
                              ) -> Tuple[torch.nn.Module, List[str], List[str]]:
    """A port generator of ``cfg`` (on ``device``, CUDA unless named) holding
    an upstream-layout G state dict (tensors or numpy arrays), the loader
    under ``load_generator_from_pth``; returns ``(g, missing,
    unexpected)`` as it does."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    return _module_from_state_dict("G", sd, cfg, device, strict, "generator state dict")


def load_generator_from_pth(weights_dir: str, name: str = "G_ema", suffix: str = "",
                            cfg: BigGANConfig = None, device=None,
                            strict: bool = True) -> Tuple[torch.nn.Module, List[str], List[str]]:
    """A port generator (on ``device``, CUDA unless named) holding the
    bundle's ``<name>[_<suffix>].pth``: BigGAN-deep's for a
    ``BigGANDeepConfig``, BigGAN's otherwise.  ``cfg`` defaults to the one
    ``state_dict[_<suffix>].pth`` records (BigGAN only).  Returns ``(g,
    missing, unexpected)``: the port's keys the bundle lacks
    (``accum_counter`` aside, zeroed) and the bundle's keys the port has no
    place for; with ``strict`` either raises ``KeyError``."""
    return _load_module("G", weights_dir, name, suffix, cfg, device, strict)


def load_discriminator_from_pth(weights_dir: str, name: str = "D", suffix: str = "",
                                cfg: BigGANConfig = None, device=None, strict: bool = True
                                ) -> Tuple[torch.nn.Module, List[str], List[str]]:
    """``load_generator_from_pth`` for the bundle's discriminator."""
    return _load_module("D", weights_dir, name, suffix, cfg, device, strict)
