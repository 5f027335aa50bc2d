"""The inference front end: port of ``ic_gan_tpu/cli/inference.py``
(reference ``inference/utils.py``): loading a trained generator from any of
its three sources, the deployment sampler around it, the conditioning draws
of the sampling CLIs and the stored-instance files.

Every loader and sampler runs on ``device``: CUDA unless the caller names
another.  Generators come back as ``nn.Module``s holding their weights (the
JAX package returns a module and its variables).  z is drawn from
``torch.Generator``s seeded as the JAX package seeds its keys, so the draws
are reproducible but not the JAX package's numbers; every other draw
(instances, labels) comes from numpy streams and matches it exactly.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ic_gan_tpu_torch import resolve_device


def reference_exp_name(cfg: Dict[str, Any]) -> str:
    """The reference demo's experiment-name convention
    (``generate_images.py:126-140``): ``{model}_{backbone}_{dataset}_res{r}``
    plus ``_nofeataug`` for the released ImageNet res-256 models."""
    res = int(cfg.get("resolution", 256))
    dataset = cfg.get("trained_dataset", cfg.get("which_dataset", "imagenet"))
    suffix = "_nofeataug" if res == 256 and dataset == "imagenet" else ""
    backbone = cfg.get("backbone", cfg.get("model_backbone", "biggan"))
    return f"{cfg.get('model', 'icgan')}_{backbone}_{dataset}_res{res}{suffix}"


def _biggan_from_checkpoint(cfg, model_cfg, train_cfg, device):
    """G (EMA unless ``use_ema`` is false) of the port's native checkpoint
    ``<weights_root>/<experiment_name>[_<suffix>]``; without ``load_weights``
    the ``best%d`` copy of lowest recorded FID, else the main one."""
    from ic_gan_tpu_torch.io.checkpoint import find_best_checkpoint, load_checkpoint
    from ic_gan_tpu_torch.models.biggan_deep import model_classes
    from ic_gan_tpu_torch.train.state import GANTrainState

    root = cfg.get("weights_root") or cfg.get("root_path") or "weights"
    name = cfg.get("experiment_name") or reference_exp_name(cfg)
    suffix = cfg.get("load_weights", "")
    if not suffix:
        best, _ = find_best_checkpoint(root, name)
        suffix = os.path.basename(best)[len(name) + 1:] if best else ""
    g_cls, d_cls = model_classes(model_cfg)
    template = GANTrainState.create(skip_init(g_cls, model_cfg, device=device),
                                    skip_init(d_cls, model_cfg, device=device),
                                    train_cfg.g_optimizer(), train_cfg.d_optimizer())
    state, _ = load_checkpoint(root, name, template, suffix)
    return state.g_ema if cfg.get("use_ema", True) else state.g


def _stylegan2_from_pickle(cfg, device):
    from ic_gan_tpu_torch.io.stylegan_import import load_network_pkl
    from ic_gan_tpu_torch.models import stylegan2 as sg2

    network_pkl = cfg.get("network_pkl")
    if not network_pkl and (cfg.get("base_root") or cfg.get("root_path")):
        # The reference's convention (inference/utils.py:406-407):
        # {base_root}/{experiment_name}/best-network-snapshot.pkl
        root = cfg.get("base_root") or cfg["root_path"]
        name = cfg.get("experiment_name") or reference_exp_name(cfg)
        cand = os.path.join(root, name, "best-network-snapshot.pkl")
        if os.path.exists(cand):
            network_pkl = cand
    if not network_pkl:
        raise ValueError("stylegan2 inference needs network_pkl")
    nets = load_network_pkl(network_pkl)
    state_dict, init_kwargs = nets.get("G_ema", nets.get("G"))
    syn_kw = dict(init_kwargs.get("synthesis_kwargs", {}))
    map_kw = dict(init_kwargs.get("mapping_kwargs", {}))
    model_cfg = sg2.StyleGAN2Config(
        img_resolution=init_kwargs.get("img_resolution", 256),
        z_dim=init_kwargs.get("z_dim", 512),
        c_dim=init_kwargs.get("c_dim", 0),
        h_dim=init_kwargs.get("h_dim", 0),
        w_dim=init_kwargs.get("w_dim", 512),
        channel_base=syn_kw.get("channel_base", 32768),
        channel_max=syn_kw.get("channel_max", 512),
        num_mapping_layers=map_kw.get("num_layers", 8),
        num_fp16_res=syn_kw.get("num_fp16_res", 4),
        conv_clamp=syn_kw.get("conv_clamp", 256.0),
        architecture_g=syn_kw.get("architecture", "skip"),
    )
    g = skip_init(sg2.Generator, model_cfg, device=device)
    g.load_state_dict(state_dict)
    return g.eval(), model_cfg


def load_generator(cfg: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None):
    """A generator for inference from one of three sources, as
    ``(g, model_cfg)``, ``g`` in eval mode on ``device`` (default CUDA):

    - ``backbone: biggan`` (the default) with ``pth_dir``: an upstream
      ``.pth`` bundle, BigGAN or BigGAN-deep as ``model`` says, its
      ``which_model`` (default ``G_ema``) of the ``suffix`` copy, or else of
      the ``best%d`` copy of lowest recorded FID
      (``inference/utils.py:285-308``);
    - ``backbone: biggan`` without it: the port's native checkpoint under
      ``weights_root`` named ``experiment_name`` (or the reference's name,
      ``reference_exp_name``);
    - ``backbone: stylegan2``: a network pickle, ``network_pkl`` or
      ``{base_root}/{experiment_name}/best-network-snapshot.pkl``.

    The BigGAN model config comes from ``split_config(cfg, inference=True)``; ``dtype``
    replaces its compute type."""
    device = resolve_device(device)
    backbone = cfg.get("backbone", "biggan")
    if backbone == "stylegan2":
        return _stylegan2_from_pickle(cfg, device)
    if backbone != "biggan":
        raise ValueError(f"unknown backbone {backbone}")
    from ic_gan_tpu_torch.cli.config import split_config

    model_cfg, train_cfg = split_config(cfg, inference=True)[:2]
    if dtype is not None:
        model_cfg = model_cfg.replace(dtype=dtype)
    if cfg.get("pth_dir"):
        from ic_gan_tpu_torch.io.torch_import import (
            load_generator_from_pth,
            select_best_pth_suffix,
        )

        suffix = cfg.get("suffix", "") or select_best_pth_suffix(cfg["pth_dir"])
        g = load_generator_from_pth(cfg["pth_dir"], cfg.get("which_model", "G_ema"), suffix,
                                    cfg=model_cfg, device=device)[0]
    else:
        g = _biggan_from_checkpoint(cfg, model_cfg, train_cfg, device)
    return g.eval(), model_cfg


def latent_dim(model_cfg) -> int:
    """The width of z either backbone reads."""
    return getattr(model_cfg, "effective_dim_z", None) or model_cfg.z_dim


def load_model_inference(cfg: Dict[str, Any], device=None):
    """A loaded generator (``load_generator``) behind the deployment sampler
    (``io.deploy.make_sampler``): σ folded, fixed batches of ``batch_size``
    (default 32), and with ``deploy_bf16`` a bf16 model whose weights are
    stored in bf16.  Returns ``(sample_fn, model_cfg)``, ``sample_fn(z,
    label=None, feats=None, device_output=False)`` → NHWC float32 images in
    [-1, 1].

    A StyleGAN2 G takes ``truncation_psi`` and ``noise_mode`` from ``cfg``,
    and integer labels are one-hot encoded into its c vector.  The sampler
    carries ``module``, ``batch_size``, ``apply_kwargs`` and ``model_cfg``,
    and ``with_standing_stats(sample_conditioning)``, which accumulates
    standing batch-norm statistics into the module (fresh z from a generator
    seeded ``seed``, ``num_standing_accumulations`` batches of
    ``standing_batch_size``; ref ``utils.py:1679-1695``) and returns the
    sampler.  ``quantize_serving`` (int8) is not ported (ROADMAP.md A.15)."""
    from ic_gan_tpu_torch.io.deploy import (
        accumulate_standing_stats,
        cast_params,
        fold_spectral_norm,
        make_sampler,
    )

    if cfg.get("quantize_serving", False):
        raise NotImplementedError("int8 serving (quantize_serving) is not ported yet "
                                  "(ROADMAP.md A.15)")
    if "backbone" not in cfg and cfg.get("model_backbone"):
        cfg = dict(cfg, backbone=cfg["model_backbone"])   # the reference demo's spelling
    device = resolve_device(device)
    backbone = cfg.get("backbone", "biggan")
    bf16 = cfg.get("deploy_bf16", False)
    g, model_cfg = load_generator(cfg, device,
                                  dtype=torch.bfloat16 if bf16 and backbone == "biggan" else None)
    fold_spectral_norm(g)
    if bf16:
        cast_params(g, torch.bfloat16)
    apply_kwargs = {}
    if backbone == "stylegan2":
        apply_kwargs = dict(truncation_psi=cfg.get("truncation_psi", 1.0),
                            noise_mode=cfg.get("noise_mode", "const"))
    batch = cfg.get("batch_size", 32)
    raw = make_sampler(g, batch_size=batch, device=device, **apply_kwargs)
    sampler = raw
    c_dim = getattr(model_cfg, "c_dim", 0) if backbone == "stylegan2" else 0
    if c_dim:
        def sampler(z, label=None, feats=None, device_output: bool = False):
            if label is not None:
                label = torch.as_tensor(label)
                if not label.is_floating_point():
                    label = F.one_hot(label.reshape(-1), c_dim).float()
            return raw(z, label, feats, device_output=device_output)

    def with_standing_stats(sample_conditioning):
        accumulate_standing_stats(
            g, torch.Generator(device=device).manual_seed(cfg.get("seed", 0)),
            sample_conditioning, batch_size=cfg.get("standing_batch_size", batch),
            n_accumulations=cfg.get("num_standing_accumulations", 16))
        return sampler

    sampler.module, sampler.batch_size, sampler.apply_kwargs = g, batch, apply_kwargs
    sampler.model_cfg = model_cfg
    sampler.with_standing_stats = with_standing_stats
    return sampler, model_cfg


def get_conditionings(num_instances: int, num_imgs_gen: int, stored_features: np.ndarray,
                      stored_labels: Optional[np.ndarray], dim_z: int, z_var: float = 1.0,
                      swap_target: Optional[int] = None, seed: int = 0,
                      index: Optional[int] = None):
    """``generate_images.py:68-124``: ``num_imgs_gen`` z's for each of the
    first ``num_instances`` stored instances (every row the instance
    ``index`` when given), their labels (all ``swap_target`` when given).
    Returns ``(z, labels, feats, instance_idxs)``: z a CPU float32 tensor
    from a generator seeded ``seed``, the rest numpy."""
    if index is not None:
        idxs = np.full(num_instances, int(index), np.int64)
    else:
        idxs = np.arange(min(num_instances, len(stored_features)))
    feats = np.repeat(stored_features[idxs], num_imgs_gen, axis=0)
    n = len(idxs) * num_imgs_gen
    z = torch.randn((n, dim_z), generator=torch.Generator().manual_seed(seed))
    z = z * math.sqrt(z_var)
    labels = None
    if stored_labels is not None:
        labels = np.repeat(np.asarray(stored_labels)[idxs], num_imgs_gen, axis=0)
    if swap_target is not None:
        labels = np.full(n, swap_target, np.int64)
    return z, labels, feats, idxs


def conditioning_flags(cfg: Dict[str, Any], model_cfg) -> Tuple[bool, bool]:
    """(class_cond, instance_cond) of either backbone: a BigGAN config
    carries them, a StyleGAN2 config implies them by ``c_dim``/``h_dim``."""
    if cfg.get("backbone", "biggan") == "stylegan2":
        return getattr(model_cfg, "c_dim", 0) > 0, getattr(model_cfg, "h_dim", 0) > 0
    return (bool(getattr(model_cfg, "class_cond", False)),
            bool(getattr(model_cfg, "instance_cond", False)))


def make_conditioned_sampler(cfg: Dict[str, Any], apply_fn, model_cfg, dataset,
                             z_var: Optional[float] = None):
    """The dataset-conditioned sampler of the sampling and eval CLIs (the
    reference's ``get_sampling_funct``, ``inference/utils.py:29-173``):
    ``sample(b) -> (images on the device, labels or None)``.

    Each call draws the conditioning from the dataset's numpy stream in its
    balance mode (``which_nn_balance``), as the JAX package does, or for a
    class-only model the labels from the generator's label distribution;
    then z ~ N(0, z_var) from a generator seeded ``seed`` + the call's count
    on the model's device.  ``sample.draw(b) -> (z, label_in, feats_in,
    labels)`` is that draw alone."""
    backbone = cfg.get("backbone", "biggan")
    class_cond, instance_cond = conditioning_flags(cfg, model_cfg)
    dim_z = latent_dim(model_cfg)
    z_var = cfg.get("z_var", 1.0) if z_var is None else z_var
    seed = cfg.get("seed", 0)
    device = next(apply_fn.module.parameters()).device
    counter = [0]
    np_rng = np.random.default_rng(seed)

    def draw(b):
        counter[0] += 1
        labels = feats = None
        if dataset is not None and instance_cond:
            if dataset.which_nn_balance == "instance_balance":
                labels, feats = dataset.sample_conditioning_instance_balance(b)
            else:
                kw = {}
                if getattr(model_cfg, "n_classes", 0):
                    kw["num_classes"] = model_cfg.n_classes
                labels, feats = dataset.sample_conditioning_nnclass_balance(b, **kw)
        elif class_cond:
            from ic_gan_tpu_torch.data.distributions import sample_gen_labels

            nc = getattr(model_cfg, "n_classes", 0) or getattr(model_cfg, "c_dim", 1)
            class_prob = None
            if cfg.get("longtail_gen", False) or cfg.get("custom_distrib_gen", False):
                if cfg.get("class_probabilities"):
                    class_prob = np.load(cfg["class_probabilities"], allow_pickle=True)
                elif dataset is not None:
                    lab_all = dataset.get_label(dataset.possible_sampling_idxs)
                    class_prob = np.bincount(np.asarray(lab_all).reshape(-1), minlength=nc)
            labels = sample_gen_labels(
                np_rng, b, nc, longtail_gen=cfg.get("longtail_gen", False),
                custom_distrib_gen=cfg.get("custom_distrib_gen", False),
                longtail_temperature=cfg.get("longtail_temperature", 1.0),
                constant_conditioning=cfg.get("constant_conditioning", False),
                class_prob=class_prob)
        gen = torch.Generator(device=device).manual_seed(seed + counter[0])
        z = torch.randn((b, dim_z), generator=gen, device=device) * math.sqrt(z_var)
        lab_in = None
        if class_cond and labels is not None:
            lab_in = torch.as_tensor(labels)
            if backbone == "stylegan2" and lab_in.dim() == 1:
                lab_in = F.one_hot(lab_in, model_cfg.c_dim).float()
        f_in = torch.as_tensor(feats) if instance_cond and feats is not None else None
        return z, lab_in, f_in, labels

    def sample(b):
        z, lab_in, f_in, labels = draw(b)
        return apply_fn(z, lab_in, f_in, device_output=True), labels if class_cond else None

    sample.class_cond, sample.instance_cond, sample.dim_z = class_cond, instance_cond, dim_z
    sample.draw, sample.apply_fn = draw, apply_fn
    return sample


def make_conditioned_feature_fn(sample, evaluator):
    """G and Inception in one function per batch
    (``eval.pipeline.make_fused_feature_fn``), fed by a conditioned
    sampler's draws: ``feature_fn(b) -> (pool, logits, labels)`` for
    ``evaluate_generator(feature_fn=...)``; None when the sampler's
    ``apply_fn`` is not a deployment sampler."""
    from ic_gan_tpu_torch.eval.pipeline import make_fused_feature_fn

    apply_fn = getattr(sample, "apply_fn", None)
    if apply_fn is None or not hasattr(apply_fn, "module"):
        return None
    fused = make_fused_feature_fn(apply_fn, evaluator)

    def feature_fn(b):
        z, lab_in, f_in, labels = sample.draw(b)
        pool, logits = fused(z, lab_in, f_in)
        return pool, logits, labels if sample.class_cond else None

    return feature_fn


def stored_instances_path(root_path: str, which_dataset: str, resolution: int,
                          model: str = "icgan") -> str:
    """The reference's stored-instances file name (``generate_images.py:
    25-37``): cc_icgan conditions on classification features, icgan on
    self-supervised (SwAV) ones."""
    extractor = "classification" if model == "cc_icgan" else "selfsupervised"
    return os.path.join(root_path, "stored_instances",
                        f"{which_dataset}_res{resolution}_rn50_{extractor}"
                        "_kmeans_k1000_instance_features.npy")


def load_stored_instances(path: str):
    """A stored instance-feature npy (the k-means selections of
    ``generate_images.py:25-45``): a plain (N, dim) array, or a dict npy with
    ``instance_features`` (or ``feats``) and optional ``labels`` and
    ``image_path`` (ground-truth images relative to the dataset root).
    Returns ``(features, labels or None, image_paths or None)``."""
    stored = np.load(path, allow_pickle=True)
    if stored.dtype == object:
        stored = stored.item()
        features = np.asarray(stored.get("instance_features", stored.get("feats")))
        return features, stored.get("labels"), stored.get("image_path")
    return np.asarray(stored), None, None


def load_stored_features(path: str):
    """``load_stored_instances`` without the image paths."""
    features, labels, _ = load_stored_instances(path)
    return features, labels


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> str:
    """NHWC float images in [-1, 1] → one PNG grid of ``nrow`` columns.
    Needs PIL, imported here so that the package imports without it."""
    from PIL import Image

    n, h, w, c = images.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    grid = np.clip((grid + 1) / 2, 0, 1)
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
    return path


def device_flag(argv=None) -> str:
    """The ``--device`` flag of the inference CLIs (default ``cuda``)."""
    import argparse

    flags = argparse.ArgumentParser(add_help=False)
    flags.add_argument("--device", type=str, default="cuda")
    return flags.parse_known_args(argv)[0].device
