"""JAX variable tree → the port's ``state_dict``.

The JAX package keeps Flax variables (``params``, ``sn``, ``batch_stats``)
in NHWC layouts: linear kernels (in, out), conv kernels HWIO.  The port's
modules use the upstream torch names and layouts: (out, in) and OIHW.  This
is the port's own copy of the generator and discriminator key maps of
``ic_gan_tpu/io/torch_import.py`` (there they map torch → JAX; here the
transforms run JAX → torch), extended by the ``accum_counter`` buffers and
by the statistics each ``norm_style`` keeps (``bn`` its three buffers,
``in`` its running mean and variance, the group norms and ``nonorm`` none).
``tree_to_torch`` applies a map to any tree shaped like one collection
(raw gradients, EMA parameters).  The StyleGAN2 trees map by rule, both ways
(``stylegan2_state_dict_from_jax``, ``stylegan2_variables_from_state_dict``).
The int8 serving mode's ``quant`` collection carries across into the port's
buffers (``generator_quant_from_jax``, ``stylegan2_quant_from_jax``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ic_gan_tpu_torch.models.biggan import BigGANConfig, d_arch, g_arch
from ic_gan_tpu_torch.models.biggan_deep import BigGANDeepConfig, deep_d_arch

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


_NORM_STATS = {"bn": (("mean", "stored_mean"), ("var", "stored_var"),
                      ("accum_counter", "accum_counter")),
               "in": (("mean", "stored_mean"), ("var", "stored_var"))}


def _bn_stats(dst, tree_path, torch_prefix, norm_style="bn"):
    for jax_name, torch_name in _NORM_STATS.get(norm_style, ()):
        dst[("batch_stats",) + tree_path + ("bn", jax_name)] = (
            f"{torch_prefix}.{torch_name}", _ident)


def _ccbn(dst, tree_path, torch_prefix, norm_style):
    _dense(dst, tree_path + ("gain",), f"{torch_prefix}.gain", bias=False)
    _dense(dst, tree_path + ("bias",), f"{torch_prefix}.bias", bias=False)
    _bn_stats(dst, tree_path, torch_prefix, norm_style)


def _attention(dst, tree_path, torch_prefix):
    for name in ("theta", "phi", "g", "o"):
        _conv(dst, tree_path + (name,), f"{torch_prefix}.{name}", bias=False)
    dst[("params",) + tree_path + ("gamma",)] = (f"{torch_prefix}.gamma", _ident)


def generator_key_map(cfg: BigGANConfig) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the generator."""
    arch = g_arch(cfg.resolution, cfg.G_ch, cfg.G_attn)
    m: Dict[Path, Tuple[str, Callable]] = {}
    _g_input(m, cfg, cfg.G_shared_feat)
    for i in range(len(arch["out_channels"])):
        p = ("block_%d" % i,)
        t = f"blocks.{i}.0"
        _ccbn(m, p + ("bn1",), f"{t}.bn1", cfg.norm_style)
        _ccbn(m, p + ("bn2",), f"{t}.bn2", cfg.norm_style)
        _conv(m, p + ("conv1",), f"{t}.conv1")
        _conv(m, p + ("conv2",), f"{t}.conv2")
        if arch["in_channels"][i] != arch["out_channels"][i] or arch["upsample"][i]:
            _conv(m, p + ("conv_sc",), f"{t}.conv_sc")
        if arch["attention"][i]:
            _attention(m, ("attn_%d" % i,), f"blocks.{i}.1")
    _g_output(m)
    return m


def _g_input(m, cfg, shared_feat):
    if cfg.class_cond:
        m[("params", "shared")] = ("shared.weight", _ident)
    if cfg.instance_cond and shared_feat:
        _dense(m, ("shared_feat",), "shared_feat")
    _dense(m, ("linear",), "linear")


def _g_output(m):
    m[("params", "output_bn", "gain")] = ("output_layer.0.gain", _ident)
    m[("params", "output_bn", "bias")] = ("output_layer.0.bias", _ident)
    _bn_stats(m, ("output_bn",), "output_layer.0")
    _conv(m, ("output_conv",), "output_layer.2")


def _d_heads(m, cfg):
    _dense(m, ("linear",), "linear")
    if cfg.class_cond:
        m[("params", "embed", "embedding")] = ("embed.weight", _ident)
        _sn_entries(m, ("embed",), "embed")
    if cfg.instance_cond:
        _dense(m, ("linear_feat",), "linear_feat")


def discriminator_key_map(cfg: BigGANConfig) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the discriminator."""
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
    _d_heads(m, cfg)
    return m


def deep_generator_key_map(cfg) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the BigGAN-deep
    generator: stage i's block j is ``blocks.{i·G_depth + j}.0``, the
    stage's attention ``.1`` of its last block.  The deep G always projects
    instance features through ``shared_feat``, as the JAX one does."""
    arch = g_arch(cfg.resolution, cfg.G_ch, cfg.G_attn)
    m: Dict[Path, Tuple[str, Callable]] = {}
    _g_input(m, cfg, shared_feat=True)
    depth = cfg.G_depth
    for i in range(len(arch["out_channels"])):
        for j in range(depth):
            p, t = (f"block_{i}_{j}",), f"blocks.{i * depth + j}.0"
            for k in range(1, 5):
                _ccbn(m, p + (f"bn{k}",), f"{t}.bn{k}", cfg.norm_style)
                _conv(m, p + (f"conv{k}",), f"{t}.conv{k}")
        if arch["attention"][i]:
            _attention(m, (f"attn_{i}",), f"blocks.{i * depth + depth - 1}.1")
    _g_output(m)
    return m


def deep_discriminator_key_map(cfg) -> Dict[Path, Tuple[str, Callable]]:
    """JAX variable path → (torch key, transform) for the BigGAN-deep
    discriminator: the stem ``input_conv``, stage i's block j at
    ``blocks.{i}.{j}``, its attention at ``blocks.{i}.{D_depth}``."""

    arch = deep_d_arch(cfg.resolution, cfg.D_ch, cfg.D_attn)
    m: Dict[Path, Tuple[str, Callable]] = {}
    _conv(m, ("input_conv",), "input_conv")
    for i in range(len(arch["out_channels"])):
        for j in range(cfg.D_depth):
            p, t = (f"block_{i}_{j}",), f"blocks.{i}.{j}"
            for k in range(1, 5):
                _conv(m, p + (f"conv{k}",), f"{t}.conv{k}")
            if j == 0 and arch["in_channels"][i] != arch["out_channels"][i]:
                _conv(m, p + ("conv_sc",), f"{t}.conv_sc")
        if arch["attention"][i]:
            _attention(m, (f"attn_{i}",), f"blocks.{i}.{cfg.D_depth}")
    _d_heads(m, cfg)
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


def generator_state_dict_from_jax(variables: Mapping,
                                  cfg: BigGANConfig) -> Dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` (CPU tensors) from a float32 JAX
    variable tree with numpy (or JAX) leaves, under BigGAN-deep's names when
    ``cfg`` is a ``BigGANDeepConfig``.  A folded tree (no ``sn`` collection)
    gives a folded state dict, without ``u0``/``sv0``: load it into a
    generator that ``io.deploy.fold_spectral_norm`` has folded."""
    deep = isinstance(cfg, BigGANDeepConfig)
    key_map = deep_generator_key_map(cfg) if deep else generator_key_map(cfg)
    return _state_dict_from_jax(variables, key_map)


def discriminator_state_dict_from_jax(variables: Mapping,
                                      cfg: BigGANConfig) -> Dict[str, torch.Tensor]:
    """The port's discriminator ``state_dict`` (CPU tensors) from a float32
    JAX variable tree (``params`` and ``sn``), under BigGAN-deep's names
    when ``cfg`` is a ``BigGANDeepConfig``."""
    deep = isinstance(cfg, BigGANDeepConfig)
    key_map = deep_discriminator_key_map(cfg) if deep else discriminator_key_map(cfg)
    return _state_dict_from_jax(variables, key_map)


def _quant_leaf(leaf: str, value) -> np.ndarray:
    """A JAX ``quant`` leaf in the port's layout: HWIO kernels OIHW, an
    ``up2x`` conv's phase kernels (4, 2, 2, I, O) → (4, O, I, 2, 2); scales
    and the ``act_dynamic`` marker as they are."""
    v = np.asarray(value)
    if leaf == "qkernel" and v.ndim == 5:
        return np.array(np.transpose(v, (0, 4, 3, 1, 2)), order="C")
    if leaf == "qkernel":
        return _t_conv(v)
    return np.array(v)


def generator_quant_from_jax(quant: Mapping, cfg: BigGANConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``quant`` collection of a BigGAN or BigGAN-deep generator
    (``ic_gan_tpu/io/quant.py:quantize_variables``) as the port's int8
    buffers, ``{"<conv>.<buffer>": CPU tensor}``, for
    ``io.quant.load_quant_state_dict``: each conv found through the key map
    of its weight."""
    deep = isinstance(cfg, BigGANDeepConfig)
    key_map = deep_generator_key_map(cfg) if deep else generator_key_map(cfg)
    convs = {path[1:-1]: key[:-len(".weight")] for path, (key, _) in key_map.items()
             if path[0] == "params" and path[-1] == "kernel"}
    return {f"{convs[path[:-1]]}.{path[-1]}": torch.from_numpy(_quant_leaf(path[-1], v))
            for path, v in _flatten(quant).items()}


def stylegan2_quant_from_jax(quant: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``quant`` collection of a StyleGAN2 generator
    (``quantize_stylegan2_variables``) as the port's int8 buffers: the
    layer's path joined by dots, the composite ``up=2`` kernel (3, 3, I, 4·O)
    → (4·O, I, 3, 3), phase major as both packages order it."""
    return {".".join(path): torch.from_numpy(_quant_leaf(path[-1], v))
            for path, v in _flatten(quant).items()}


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


# --- InceptionV3 ------------------------------------------------------------------
#
# The inverse of ``ic_gan_tpu/models/inception.py:load_torch_inception``:
# ``<m>/conv/kernel`` HWIO → ``<m>.conv.weight`` OIHW, ``<m>/bn_{weight,bias,
# mean,var}`` → ``<m>.bn.{weight,bias,running_mean,running_var}``, the ``fc``
# kernel (in, out) → ``fc.weight`` (out, in).

_INCEPTION_BN = {"bn_weight": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
                 "bn_var": "running_var"}


def inception_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``InceptionV3`` state dict (CPU tensors) from the JAX
    InceptionV3 variables (``{"params": ...}``, numpy or JAX leaves)."""
    out = {}
    for path, value in _flatten(variables["params"]).items():
        if path[-2:] == ("conv", "kernel"):
            key, value = ".".join(path[:-2]) + ".conv.weight", _t_conv(value)
        elif path[-1] in _INCEPTION_BN:
            key, value = ".".join(path[:-1]) + ".bn." + _INCEPTION_BN[path[-1]], _ident(value)
        elif path == ("fc", "kernel"):
            key, value = "fc.weight", _t_linear(value)
        elif path == ("fc", "bias"):
            key, value = "fc.bias", _ident(value)
        else:
            raise KeyError(f"unknown InceptionV3 variable {'/'.join(path)}")
        out[key] = torch.from_numpy(value)
    return out


# --- ResNet-50 --------------------------------------------------------------------
#
# The inverse of ``ic_gan_tpu/models/resnet.py:load_torch_resnet50``: Flax
# ``conv1``/``bn1``, ``layer{L}_{b}/{conv,bn}{1,2,3}`` and
# ``downsample_{conv,bn}``, ``fc`` → torchvision's ``layer{L}.{b}.conv1``,
# ``downsample.0``/``.1`` …; batch norm ``scale``/``bias``/``mean``/``var``
# → ``weight``/``bias``/``running_mean``/``running_var``.

_RESNET_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def resnet_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet50`` state dict (CPU tensors, torchvision's names)
    from the JAX ResNet-50 variables (``{"params": ...}``)."""
    out = {}
    for path, value in _flatten(variables["params"]).items():
        *mods, leaf = path
        if mods[0].startswith("layer"):
            layer, block = mods[0].split("_")
            sub = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(mods[1], mods[1])
            prefix = f"{layer}.{block}.{sub}"
        else:
            prefix = mods[0]
        if leaf == "kernel":
            key, value = f"{prefix}.weight", (_t_conv(value) if np.ndim(value) == 4
                                              else _t_linear(value))
        elif prefix == "fc":
            key, value = f"fc.{leaf}", _ident(value)
        else:
            key, value = f"{prefix}.{_RESNET_BN[leaf]}", _ident(value)
        out[key] = torch.from_numpy(value)
    return out


# The inverse of ``ic_gan_tpu/models/vgg.py:load_torchvision_vgg16``: Flax
# ``features_{i}`` (HWIO ``kernel``, ``bias``) and the five ``lin_{i}``
# channel weights → torchvision's ``features.{i}.weight`` (OIHW) and
# ``.bias``, and the port's ``lin_{i}``.


def vgg_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``VGG16`` state dict (CPU tensors) from the JAX VGG16
    variables (``{"params": ...}``)."""
    out = {}
    for path, value in _flatten(variables["params"]).items():
        if path[0].startswith("features_"):
            idx, leaf = path[0][len("features_"):], path[1]
            key = f"features.{idx}.{'weight' if leaf == 'kernel' else leaf}"
            value = _t_conv(value) if leaf == "kernel" else _ident(value)
        else:
            key, value = path[0], _ident(value)
        out[key] = torch.from_numpy(np.asarray(value, np.float32))
    return out
