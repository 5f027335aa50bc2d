"""Config plumbing of the training CLIs: a JSON config overlaid with
``--set key=value`` pairs, checked against the keys each CLI reads and
split into the port's typed configs.

Port of ``ic_gan_tpu/cli/config.py``: ``parse_args`` (reference pattern
``BigGAN_PyTorch/run.py:30-43``); for ``cli/train.py`` (BigGAN)
``split_config``, ``name_from_config`` and the BigGAN keys; for
``cli/train_stylegan2.py`` ``data_config``, the dataset half of the split.
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import Any, Dict, Tuple

import torch

# The StyleGAN2 front-end keys ``setup_configs`` reads (ref
# stylegan2_ada_pytorch/parser.py:9-254).
SG2_KEYS = {
    "exp_name", "outdir", "run_dir", "cfg", "data", "root_feats", "root_nns",
    "gamma", "kimg", "lrate", "glr", "dlr", "aug", "augpipe", "p", "target",
    "mirror", "snap", "kimg_per_tick", "batch", "batch_size", "map",
    "z_dim", "c_dim", "h_dim", "w_dim", "hidden_dim_c", "hidden_dim_h",
    "num_fp16_res", "freezed", "subset", "label_dim", "cond",
    "num_channel_g", "num_channel_d", "channel_max_g", "channel_max_d",
}
# Read by ``data_config`` (ref BigGAN_PyTorch/utils.py data flags).
DATA_KEYS = {
    "resolution", "data_root", "data_path", "which_dataset", "longtail",
    "class_cond", "instance_cond", "feature_extractor",
    "backbone_feature_extractor", "which_knn_balance", "which_nn_balance",
    "kmeans_subsampled", "n_subsampled_data", "feature_augmentation", "k_nn",
    "hflips", "augment", "load_in_mem_feats", "filter_hd",
}
# Read by ``main`` and its eval (``make_eval_fn``).
RUN_KEYS = {
    "json_config", "experiment_name", "seed", "no_tb", "max_steps", "eval_metrics",
    "inception_weights", "num_inception_images", "eval_batch_size", "eval_bf16",
}
# Understood and replaced by the port's design: one process drives one
# device, and the dataset is sampled in process.
SUPERSEDED_KEYS = {
    "run_setup", "ddp_train", "parallel", "num_workers", "shuffle",
    "no_pin_memory", "pin_memory", "load_in_mem", "use_multiepoch_sampler",
    "use_checkpointable_sampler", "cross_replica", "syncbn", "mybn",
    "slurm", "slurm_logdir", "slurm_time", "partition", "port", "gpus",
    "nodes", "workers", "nobench", "nhwc", "fp32", "pbar",
    # sample.py's in-run IS/FID recompute, superseded by an eval CLI.
    "sample_inception_metrics",
}

# The BigGAN keys that ``cli/train.py`` reads, through ``split_config``
# (model, train step, trainer, data), ``name_from_config`` (the experiment
# name's tokens), ``main`` itself and its eval (``eval.pipeline.
# make_train_eval_fn``).  The other apps' keys (``INFERENCE_KEYS``,
# ``APP_KEYS``) warn here, as every key this CLI would drop.
BIGGAN_KEYS = {
    # model geometry
    "model", "resolution", "n_classes", "G_ch", "D_ch", "dim_z",
    "bottom_width", "G_attn", "D_attn", "G_shared", "shared_dim", "hier",
    "class_cond", "instance_cond", "G_shared_feat", "shared_dim_feat",
    "SN_eps", "BN_eps", "num_G_SVs", "num_D_SVs", "num_G_SV_itrs", "D_thin",
    "D_wide", "bf16", "norm_style",
    # train step
    "num_D_steps", "num_D_accumulations", "num_G_accumulations", "G_lr",
    "D_lr", "G_B1", "G_B2", "D_B1", "D_B2", "adam_eps", "which_loss", "ema",
    "ema_decay", "ema_start", "G_ortho", "D_ortho", "DA", "DiffAugment",
    "z_var", "split_D",
    # trainer
    "experiment_name", "weights_root", "logs_root", "base_root", "n_nodes",
    "n_gpus_per_node", "num_epochs", "test_every", "save_every",
    "num_save_copies", "num_best_copies", "which_best", "es_patience", "seed",
    "deterministic_run", "batch_size", "use_ema", "accumulate_stats",
    "num_standing_accumulations", "stop_when_diverge", "sv_log_interval",
    "log_G_spectra", "log_D_spectra", "log_every", "no_tb", "G_init",
    "D_init", "skip_init", "longtail_gen", "custom_distrib_gen",
    "longtail_temperature", "constant_conditioning", "class_probabilities",
    "longtail", "use_balanced_sampler", "profile_dir", "profile_start",
    # data
    "data_root", "data_path", "which_dataset", "feature_extractor",
    "backbone_feature_extractor", "which_knn_balance", "which_nn_balance",
    "kmeans_subsampled", "n_subsampled_data", "feature_augmentation", "k_nn",
    "hflips", "augment", "load_in_mem_feats", "filter_hd",
    # BigGAN-deep (G_depth, D_depth) and a name token
    "which_train_fn", "G_depth", "D_depth",
    # main: the config file, a cluster launch (it raises, ROADMAP.md A.9),
    # eval, resume and the epoch length
    "json_config", "jax_distributed", "num_processes", "eval_metrics",
    "inception_weights", "num_inception_images", "eval_batch_size", "eval_bf16",
    "resume", "load_weights", "steps_per_epoch",
}

# Read by the inference front end (``cli/inference.py``) and its CLIs
# (``generate_images``, ``sample``, ``demo``, ``test``, ``calc_metrics``).
INFERENCE_KEYS = {
    "backbone", "model_backbone", "pth_dir", "network_pkl", "suffix", "which_model",
    "root_path", "trained_dataset", "deploy_bf16", "truncation_psi", "noise_mode",
    "standing_batch_size", "quantize_serving", "quant_calibration_images", "quantize_dynamic",
    "stored_features", "num_conditionings_gen",
    "num_imgs_gen", "index", "swap_target", "visualize_instance_images", "dataset_path",
    "out_path", "out_dir", "num_imgs", "num_samples", "input_image",
    "feature_extractor_weights",
    # the eval CLIs (cli/test.py, cli/calc_metrics.py)
    "eval_prdc", "prdc_ref_images", "prdc_nearest_k", "stratified_moments",
    "samples_per_class_path", "fused_eval", "sample_trunc_curves", "metrics_out",
    "sample_npz", "sample_num_npz", "npz_path", "metrics", "max_real_images",
    "ppl_num_samples", "run_dir",
}

# Read by the sheet, projection, CLIP-guidance, TFHub and official-eval CLIs
# (``cli/visualize.py``, ``projector.py``, ``clip_guided.py``,
# ``convert_tfhub.py``, ``official_eval.py``), known wherever the inference
# keys are.
APP_KEYS = {
    # visualize (ref sample.py, style_mixing.py) and the projector
    "mode", "sample_sheets", "sample_interps", "sample_random", "sample_sheet_folder_num",
    "num_midpoints", "num_rows", "row_seeds", "col_seeds", "col_styles",
    "input_feature_index", "target", "num_steps", "w_avg_samples",
    # CLIP-guided search (the colab's knobs)
    "prompt", "clip_weights", "bpe_path", "instance_features_npy", "class_index",
    "optimizer", "pop_size", "iterations", "terminal_iterations", "truncation",
    "augmentations", "learning_rate", "noise_normality_loss", "out",
    # TFHub conversion
    "dump", "pth_out", "sample_grid", "sample_batch", "no_ema",
    # official TF1 eval
    "pb_path", "samples", "pool_npz", "use_ground_truth_data", "fid_a", "fid_b", "split",
}

# Supported only at the reference default; anything else warns.
DEFAULT_ONLY_KEYS = {
    "G_param": "SN", "D_param": "SN",           # only spectral norm
    # relu family only — the full extent of the reference's activation_dict
    # (utils.py:943-947: inplace_relu/relu/ir are all nn.ReLU).
    "G_nl": ["relu", "inplace_relu", "ir"],
    "D_nl": ["relu", "inplace_relu", "ir"],
    "G_fp16": False, "D_fp16": False,            # native bf16 instead
    "G_mixed_precision": False, "D_mixed_precision": False,
    "toggle_grads": True,
    "hashname": False, "config_from_name": False,
    "name_suffix": "", "logstyle": "%3.3e",
}


def validate_config(cfg: Dict[str, Any], backbone: str = "stylegan2",
                    inference: bool = False) -> list:
    """Warn on every key of ``cfg`` that the ``backbone``'s CLI would drop:
    for ``stylegan2`` the keys ``cli/train_stylegan2.py`` reads; for
    ``biggan`` the keys ``cli/train.py`` reads (with ``inference``, also
    those of the inference and the other apps' CLIs), and a default-only
    key away from its reference value.  Returns the problem strings."""
    problems = []
    if backbone == "stylegan2":
        known = SG2_KEYS | DATA_KEYS | RUN_KEYS | SUPERSEDED_KEYS
    else:
        known = BIGGAN_KEYS | SUPERSEDED_KEYS | set(DEFAULT_ONLY_KEYS)
        if inference:
            known |= INFERENCE_KEYS | APP_KEYS
    for key, value in cfg.items():
        if backbone != "stylegan2" and key in DEFAULT_ONLY_KEYS:
            allowed = DEFAULT_ONLY_KEYS[key]
            ok = value in allowed if isinstance(allowed, list) else value == allowed
            if not ok:
                problems.append(f"config key {key!r}={value!r} is only supported at its "
                                f"reference default ({allowed!r})")
        elif key not in known:
            problems.append(f"unknown config key {key!r} would be dropped")
    for p in problems:
        warnings.warn(p, stacklevel=2)
    return problems


def data_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments of ``data.datasets.get_dataset_hdf5`` from a
    flat reference-style StyleGAN2 config, as the JAX ``split_config``
    gives them (its fourth result); checks the keys first
    (``validate_config``)."""
    validate_config(cfg)
    return _data_kwargs(cfg)


def _data_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    g = cfg.get
    data_kwargs = dict(
        resolution=g("resolution", 64),
        data_path=g("data_root", g("data_path", "data")),
        which_dataset=g("which_dataset", "imagenet"),
        longtail=g("longtail", False),
        class_cond=g("class_cond", False),
        instance_cond=g("instance_cond", False),
        feature_extractor=g("feature_extractor", "classification"),
        backbone_feature_extractor=g("backbone_feature_extractor", "resnet50"),
        which_nn_balance=g(
            "which_knn_balance", g("which_nn_balance", "instance_balance")
        ),
        kmeans_subsampled=g("kmeans_subsampled", -1),
        n_subsampled_data=g("n_subsampled_data", -1),
        feature_augmentation=g("feature_augmentation", False),
        k_nn=g("k_nn", 50),
        # "augment" (ref utils.py:58: random flips on the hdf5 path,
        # data_utils/utils.py:613-617) is an alias of "hflips" here.
        hflip=g("hflips", False) or g("augment", False),
        load_in_mem_feats=g("load_in_mem_feats", True),
    )
    if g("filter_hd", -1) != -1:
        data_kwargs["filter_hd"] = g("filter_hd")
    return data_kwargs


def split_config(cfg: Dict[str, Any], inference: bool = False):
    """Split a reference-style flat BigGAN config into ``(model config,
    TrainConfig, TrainerConfig, data_kwargs)``, as the JAX ``split_config``
    does, after ``validate_config`` (``inference`` for the inference CLIs'
    keys).  ``model: BigGANdeep`` gives a
    ``BigGANDeepConfig`` (dim_z 128, ``G_depth``/``D_depth`` 2 by default,
    no ``D_wide``; ref ``trainer.py:122``), else a ``BigGANConfig``.
    ``batch_size`` is the reference's per-rank microbatch; the trainer's is
    that times ``n_nodes · n_gpus_per_node``, so a step sees the reference
    run's images.  ``bf16`` selects bfloat16 compute."""
    from ic_gan_tpu_torch.models.biggan import BigGANConfig
    from ic_gan_tpu_torch.models.biggan_deep import BigGANDeepConfig

    validate_config(cfg, backbone="biggan", inference=inference)
    g = cfg.get
    common = dict(
        resolution=g("resolution", 64),
        n_classes=g("n_classes", 1000),
        G_ch=g("G_ch", 64),
        D_ch=g("D_ch", 64),
        G_attn=str(g("G_attn", "64")),
        D_attn=str(g("D_attn", "64")),
        G_shared=g("G_shared", True),
        shared_dim=g("shared_dim", 0) or g("dim_z", 120),
        hier=g("hier", False),
        class_cond=g("class_cond", False),
        instance_cond=g("instance_cond", False),
        G_shared_feat=g("G_shared_feat", False),
        shared_dim_feat=g("shared_dim_feat", 2048),
        num_G_SVs=g("num_G_SVs", 1),
        num_D_SVs=g("num_D_SVs", 1),
        num_SV_itrs=g("num_G_SV_itrs", 1),
        SN_eps=g("SN_eps", 1e-6),
        BN_eps=g("BN_eps", 1e-5),
        norm_style=g("norm_style", "bn"),
        dtype=torch.bfloat16 if g("bf16", False) else torch.float32,
    )
    if g("model", "BigGAN") == "BigGANdeep":
        model = BigGANDeepConfig(dim_z=g("dim_z", 128), G_depth=g("G_depth", 2),
                                 D_depth=g("D_depth", 2), **common)
    else:
        model = BigGANConfig(D_wide=g("D_wide", g("D_thin", True)), dim_z=g("dim_z", 120),
                             bottom_width=g("bottom_width", 4), **common)
    return (model,) + _split_train_and_data(cfg)


def _split_train_and_data(cfg: Dict[str, Any]) -> Tuple:
    from ic_gan_tpu_torch.train.step import TrainConfig
    from ic_gan_tpu_torch.train.trainer import TrainerConfig

    g = cfg.get
    train = TrainConfig(
        num_D_steps=g("num_D_steps", 2),
        num_D_accumulations=g("num_D_accumulations", 1),
        num_G_accumulations=g("num_G_accumulations", 1),
        G_lr=g("G_lr", 5e-5),
        D_lr=g("D_lr", 2e-4),
        G_B1=g("G_B1", 0.0),
        G_B2=g("G_B2", 0.999),
        D_B1=g("D_B1", 0.0),
        D_B2=g("D_B2", 0.999),
        adam_eps=g("adam_eps", 1e-6),
        loss=g("which_loss", "hinge"),
        ema=g("ema", False),
        ema_decay=g("ema_decay", 0.9999),
        ema_start=g("ema_start", 20000),
        G_ortho=g("G_ortho", 0.0),
        D_ortho=g("D_ortho", 0.0),
        DiffAugment=g("DiffAugment", "") if g("DA", False) else "",
        z_var=g("z_var", 1.0),
        class_cond=g("class_cond", False),
        instance_cond=g("instance_cond", False),
        split_D=g("split_D", False),
    )
    # Root pegging (ref utils.py:1018-1025): base_root redirects
    # weights/logs/samples.
    base = g("base_root", "")
    world = g("n_nodes", 1) * g("n_gpus_per_node", 1)
    trainer = TrainerConfig(
        # Named from the config when unset (trainer.py:124-127).
        experiment_name=g("experiment_name") or name_from_config(cfg),
        weights_root=g("weights_root", f"{base}/weights" if base else "weights"),
        logs_root=g("logs_root", f"{base}/logs" if base else "logs"),
        num_epochs=g("num_epochs", 100),
        test_every=g("test_every", 5),
        save_every=g("save_every", 1),
        num_save_copies=g("num_save_copies", 2),
        num_best_copies=g("num_best_copies", 2),
        which_best=g("which_best", "IS"),
        es_patience=g("es_patience", 50),
        seed=g("seed", 0),
        deterministic_run=g("deterministic_run", False),
        batch_size=g("batch_size", 64) * world,
        world_size=world,
        use_ema=g("use_ema", False),
        accumulate_stats=g("accumulate_stats", False),
        num_standing_accumulations=g("num_standing_accumulations", 16),
        stop_when_diverge=g("stop_when_diverge", False),
        sv_log_interval=g("sv_log_interval", 0),
        log_G_spectra=g("log_G_spectra", False),
        log_D_spectra=g("log_D_spectra", False),
        log_every=g("log_every", 100),
        enable_tb=not g("no_tb", False),
        profile_dir=g("profile_dir", None),
        profile_start=g("profile_start", 10),
        G_init=g("G_init", "ortho"),
        D_init=g("D_init", "ortho"),
        skip_init=g("skip_init", False),
        longtail_gen=g("longtail_gen", False),
        custom_distrib_gen=g("custom_distrib_gen", False),
        longtail_temperature=g("longtail_temperature", 1.0),
        constant_conditioning=g("constant_conditioning", False),
        class_probabilities=g("class_probabilities", None),
        longtail=g("longtail", False),
        use_balanced_sampler=g("use_balanced_sampler", False),
    )
    return train, trainer, _data_kwargs(cfg)


def name_from_config(cfg: Dict[str, Any]) -> str:
    """Auto-generate the experiment name from the config.

    Reference: ``BigGAN_PyTorch/utils.py:1602-1650`` (``name_from_config``),
    called from ``trainer.py:124-127`` whenever ``experiment_name`` is empty.
    The fork inherits this function from upstream BigGAN-PyTorch but drops both
    its ``return name`` and the ``--dataset`` flag it reads, so the fork's own
    call site actually receives ``None``; this implements the *intended*
    contract — same tokens, same omission-at-default rules, same formats.
    The dataset token is reconstructed as ``{I|COCO}{resolution}_hdf5``, the
    fork's dataset/moment naming convention (``trainer.py:303-307``,
    ``data_utils/utils.py`` hdf5 filenames).
    """
    g = cfg.get
    ds_prefix = "I" if g("which_dataset", "imagenet") == "imagenet" else "COCO"
    items = [
        "Big%s" % g("which_train_fn", "GAN"),
        "%s%d_hdf5" % (ds_prefix, g("resolution", 64)),
        g("model", "BigGAN") if g("model", "BigGAN") != "BigGAN" else None,
        "seed%d" % g("seed", 0),
        "Gch%d" % g("G_ch", 64),
        "Dch%d" % g("D_ch", 64),
        "Gd%d" % g("G_depth", 1) if g("G_depth", 1) > 1 else None,
        "Dd%d" % g("D_depth", 1) if g("D_depth", 1) > 1 else None,
        "bs%d" % g("batch_size", 64),
        "Gfp16" if g("G_fp16", False) else None,
        "Dfp16" if g("D_fp16", False) else None,
        "nDs%d" % g("num_D_steps", 2) if g("num_D_steps", 2) > 1 else None,
        "nDa%d" % g("num_D_accumulations", 1)
        if g("num_D_accumulations", 1) > 1 else None,
        "nGa%d" % g("num_G_accumulations", 1)
        if g("num_G_accumulations", 1) > 1 else None,
        "Glr%2.1e" % g("G_lr", 5e-5),
        "Dlr%2.1e" % g("D_lr", 2e-4),
        "GB%3.3f" % g("G_B1", 0.0) if g("G_B1", 0.0) != 0.0 else None,
        "GBB%3.3f" % g("G_B2", 0.999) if g("G_B2", 0.999) != 0.999 else None,
        "DB%3.3f" % g("D_B1", 0.0) if g("D_B1", 0.0) != 0.0 else None,
        "DBB%3.3f" % g("D_B2", 0.999) if g("D_B2", 0.999) != 0.999 else None,
        "Gnl%s" % g("G_nl", "relu"),
        "Dnl%s" % g("D_nl", "relu"),
        "Ginit%s" % g("G_init", "ortho"),
        "Dinit%s" % g("D_init", "ortho"),
        "G%s" % g("G_param", "SN") if g("G_param", "SN") != "SN" else None,
        "D%s" % g("D_param", "SN") if g("D_param", "SN") != "SN" else None,
        "Gattn%s" % g("G_attn", "64") if str(g("G_attn", "64")) != "0" else None,
        "Dattn%s" % g("D_attn", "64") if str(g("D_attn", "64")) != "0" else None,
        "Gortho%2.1e" % g("G_ortho", 0.0) if g("G_ortho", 0.0) > 0.0 else None,
        "Dortho%2.1e" % g("D_ortho", 0.0) if g("D_ortho", 0.0) > 0.0 else None,
        g("norm_style", "bn") if g("norm_style", "bn") != "bn" else None,
        "cr" if g("cross_replica", False) else None,
        "Gshared" if g("G_shared", True) else None,
        "hier" if g("hier", False) else None,
        "ema" if g("ema", False) else None,
        g("name_suffix", "") if g("name_suffix", "") else None,
    ]
    return "_".join(item for item in items if item is not None)


def parse_args(argv=None) -> Dict[str, Any]:
    """CLI: ``--json_config path`` overlaid with ``--set key=value`` pairs
    (reference pattern: run.py:30-43).  Other flags are left to the caller."""
    p = argparse.ArgumentParser(description="ic_gan_tpu_torch")
    p.add_argument("--json_config", type=str, default="")
    p.add_argument(
        "--set", nargs="*", default=[],
        help="key=value overrides (JSON-decoded values)",
    )
    args, _ = p.parse_known_args(argv)
    cfg: Dict[str, Any] = {}
    if args.json_config:
        with open(args.json_config) as f:
            cfg.update(json.load(f))
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            cfg[k] = json.loads(v)
        except json.JSONDecodeError:
            cfg[k] = v
    return cfg
