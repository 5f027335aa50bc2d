"""JAX variable tree → the port's ``state_dict``.

The JAX package keeps Flax variables (``params``, ``sn``, ``batch_stats``)
in NHWC layouts: linear kernels (in, out), conv kernels HWIO.  The port's
modules use the upstream torch names and layouts: (out, in) and OIHW.  This
is the port's own copy of the generator and discriminator key maps of
``ic_gan_tpu/io/torch_import.py`` (there they map torch → JAX; here the
transforms run JAX → torch), extended by the ``accum_counter`` buffers.
``tree_to_torch`` applies a map to any tree shaped like one collection
(raw gradients, EMA parameters).  The StyleGAN2 trees map by rule, both ways
(``stylegan2_state_dict_from_jax``, ``stylegan2_variables_from_state_dict``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ic_gan_tpu_torch.models.biggan import BigGANConfig, d_arch, g_arch

Path = Tuple[str, ...]


def _t_linear(w):  # (in, out) → (out, in), a writable copy
    return np.array(np.asarray(w).T, order="C")


def _t_conv(w):  # HWIO → OIHW, a writable copy
    return np.array(np.transpose(np.asarray(w), (3, 2, 0, 1)), order="C")


def _ident(w):
    return np.array(w)


def _sn_entries(dst, tree_path, torch_prefix):
    dst[("sn",) + tree_path + ("u",)] = (f"{torch_prefix}.u0", _ident)
    dst[("sn",) + tree_path + ("sv",)] = (f"{torch_prefix}.sv0", _ident)


def _dense(dst, tree_path, torch_prefix, bias=True):
    dst[("params",) + tree_path + ("kernel",)] = (f"{torch_prefix}.weight", _t_linear)
    if bias:
        dst[("params",) + tree_path + ("bias",)] = (f"{torch_prefix}.bias", _ident)
    _sn_entries(dst, tree_path, torch_prefix)


def _conv(dst, tree_path, torch_prefix, bias=True):
    dst[("params",) + tree_path + ("kernel",)] = (f"{torch_prefix}.weight", _t_conv)
    if bias:
        dst[("params",) + tree_path + ("bias",)] = (f"{torch_prefix}.bias", _ident)
    _sn_entries(dst, tree_path, torch_prefix)


def _bn_stats(dst, tree_path, torch_prefix):
    for jax_name, torch_name in (("mean", "stored_mean"), ("var", "stored_var"),
                                 ("accum_counter", "accum_counter")):
        dst[("batch_stats",) + tree_path + ("bn", jax_name)] = (
            f"{torch_prefix}.{torch_name}", _ident)


def _ccbn(dst, tree_path, torch_prefix):
    _dense(dst, tree_path + ("gain",), f"{torch_prefix}.gain", bias=False)
    _dense(dst, tree_path + ("bias",), f"{torch_prefix}.bias", bias=False)
    _bn_stats(dst, tree_path, torch_prefix)


def _attention(dst, tree_path, torch_prefix):
    for name in ("theta", "phi", "g", "o"):
        _conv(dst, tree_path + (name,), f"{torch_prefix}.{name}", bias=False)
    dst[("params",) + tree_path + ("gamma",)] = (f"{torch_prefix}.gamma", _ident)


def generator_key_map(cfg: BigGANConfig) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the generator."""
    if cfg.class_cond:
        raise NotImplementedError("the class-conditional generator is not ported yet")
    arch = g_arch(cfg.resolution, cfg.G_ch, cfg.G_attn)
    m: Dict[Path, Tuple[str, Callable]] = {}
    if cfg.instance_cond and cfg.G_shared_feat:
        _dense(m, ("shared_feat",), "shared_feat")
    _dense(m, ("linear",), "linear")
    for i in range(len(arch["out_channels"])):
        p = ("block_%d" % i,)
        t = f"blocks.{i}.0"
        _ccbn(m, p + ("bn1",), f"{t}.bn1")
        _ccbn(m, p + ("bn2",), f"{t}.bn2")
        _conv(m, p + ("conv1",), f"{t}.conv1")
        _conv(m, p + ("conv2",), f"{t}.conv2")
        if arch["in_channels"][i] != arch["out_channels"][i] or arch["upsample"][i]:
            _conv(m, p + ("conv_sc",), f"{t}.conv_sc")
        if arch["attention"][i]:
            _attention(m, ("attn_%d" % i,), f"blocks.{i}.1")
    m[("params", "output_bn", "gain")] = ("output_layer.0.gain", _ident)
    m[("params", "output_bn", "bias")] = ("output_layer.0.bias", _ident)
    _bn_stats(m, ("output_bn",), "output_layer.0")
    _conv(m, ("output_conv",), "output_layer.2")
    return m


def discriminator_key_map(cfg: BigGANConfig) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the discriminator."""
    if cfg.class_cond:
        raise NotImplementedError(
            "the class-conditional discriminator is not ported yet (ROADMAP.md A.3)")
    arch = d_arch(cfg.resolution, cfg.D_ch, cfg.D_attn)
    m: Dict[Path, Tuple[str, Callable]] = {}
    for i in range(len(arch["out_channels"])):
        p = ("block_%d" % i,)
        t = f"blocks.{i}.0"
        _conv(m, p + ("conv1",), f"{t}.conv1")
        _conv(m, p + ("conv2",), f"{t}.conv2")
        if arch["in_channels"][i] != arch["out_channels"][i] or arch["downsample"][i]:
            _conv(m, p + ("conv_sc",), f"{t}.conv_sc")
        if arch["attention"][i]:
            _attention(m, ("attn_%d" % i,), f"blocks.{i}.1")
    _dense(m, ("linear",), "linear")
    if cfg.instance_cond:
        _dense(m, ("linear_feat",), "linear_feat")
    return m


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _state_dict_from_jax(variables: Mapping, key_map) -> Dict[str, torch.Tensor]:
    flat = _flatten(variables)
    folded = "sn" not in variables
    out = {}
    for path, (key, transform) in key_map.items():
        if folded and path[0] == "sn":
            continue
        if path not in flat:
            raise KeyError(f"JAX variables are missing {'/'.join(path)}")
        out[key] = torch.from_numpy(transform(flat[path]))
    return out


def generator_state_dict_from_jax(variables: Mapping, cfg: BigGANConfig
                                  ) -> Dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` (CPU tensors) from a float32 JAX
    variable tree with numpy (or JAX) leaves.  A folded tree (no ``sn``
    collection) gives a folded state dict, without ``u0``/``sv0``: load it
    into a generator that ``io.deploy.fold_spectral_norm`` has folded."""
    return _state_dict_from_jax(variables, generator_key_map(cfg))


def discriminator_state_dict_from_jax(variables: Mapping, cfg: BigGANConfig
                                      ) -> Dict[str, torch.Tensor]:
    """The port's discriminator ``state_dict`` (CPU tensors) from a float32
    JAX variable tree (``params`` and ``sn``)."""
    return _state_dict_from_jax(variables, discriminator_key_map(cfg))


def tree_to_torch(tree: Mapping, key_map) -> Dict[str, torch.Tensor]:
    """A tree shaped like the ``params`` collection of G or D (raw gradients,
    EMA parameters) → {torch name: CPU tensor}, through the same transforms
    as the weights.  ``key_map`` is ``generator_key_map(cfg)`` or
    ``discriminator_key_map(cfg)``; every ``params`` path in it must be
    present."""
    return _state_dict_from_jax(
        {"params": tree}, {p: v for p, v in key_map.items() if p[0] == "params"})


# --- StyleGAN2 -------------------------------------------------------------------
#
# The JAX StyleGAN2 tree already carries the upstream names (``mapping/fc0``,
# ``synthesis/b4/conv1/affine``, ``b4/out`` …), so the map is by rule: the
# torch key is the path below the collection, joined by dots, and the layout
# follows the leaf.  Collections: ``params``; ``noise`` (``noise_const``);
# ``batch_stats`` (``w_avg``).

_SG2_BUFFERS = {"noise_const": "noise", "w_avg": "batch_stats"}


def _sg2_to_torch(path: Path, value) -> np.ndarray:
    v = np.asarray(value)
    if path[-1] == "weight" and v.ndim == 4:
        return _t_conv(v)
    if path[-1] == "weight" and v.ndim == 2:
        return _t_linear(v)
    if path[-1] == "const":                       # (H, W, C) → (C, H, W)
        return np.array(np.transpose(v, (2, 0, 1)), order="C")
    return np.array(v)


def _sg2_to_jax(key: str, value: np.ndarray) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight" and value.ndim == 4:      # OIHW → HWIO
        return np.array(np.transpose(value, (2, 3, 1, 0)), order="C")
    if leaf == "weight" and value.ndim == 2:
        return np.array(value.T, order="C")
    if leaf == "const":
        return np.array(np.transpose(value, (1, 2, 0)), order="C")
    return np.array(value)


def stylegan2_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's StyleGAN2 G or D ``state_dict`` (CPU tensors) from a JAX
    variable tree with numpy (or JAX) leaves: conv kernels HWIO → OIHW, FC
    kernels (in, out) → (out, in), ``const`` HWC → CHW; ``noise_const`` and
    ``w_avg`` carry over.  A tree shaped like ``params`` alone (raw
    gradients, EMA parameters) goes in as ``{"params": tree}``."""
    out = {}
    for path, v in _flatten(variables).items():
        if path[0] not in ("params", "noise", "batch_stats"):
            raise KeyError(f"unexpected StyleGAN2 collection {'/'.join(path)}")
        out[".".join(path[1:])] = torch.from_numpy(_sg2_to_torch(path, v))
    return out


def stylegan2_variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a port ``state_dict`` → the JAX variable tree (numpy
    leaves, nested dicts by collection)."""
    tree: dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        node = tree.setdefault(_SG2_BUFFERS.get(parts[-1], "params"), {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _sg2_to_jax(key, t.detach().cpu().numpy())
    return tree
