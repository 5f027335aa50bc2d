"""Config plumbing of the StyleGAN2 CLI: a JSON config overlaid with
``--set key=value`` pairs, and its dataset half.

The port's copy of what ``cli/train_stylegan2.py`` reads from
``ic_gan_tpu/cli/config.py``: ``parse_args`` (reference pattern
``BigGAN_PyTorch/run.py:30-43``) and the data keyword arguments of
``split_config`` (``_split_train_and_data``), with the key check narrowed to
the keys this CLI reads.  Nothing BigGAN-specific.
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import Any, Dict

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
# Read by ``main``; the eval keys once FID evaluation is ported (ROADMAP.md A.12).
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
}


def validate_config(cfg: Dict[str, Any]) -> list:
    """Warn on every key of ``cfg`` that the StyleGAN2 CLI would drop.
    Returns the problem strings."""
    known = SG2_KEYS | DATA_KEYS | RUN_KEYS | SUPERSEDED_KEYS
    problems = [f"unknown config key {key!r} would be dropped"
                for key in cfg if key not in known]
    for p in problems:
        warnings.warn(p, stacklevel=2)
    return problems


def data_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keyword arguments of ``data.datasets.get_dataset_hdf5`` from a
    flat reference-style config, as the JAX ``split_config`` gives them
    (its fourth result); checks the keys first (``validate_config``)."""
    validate_config(cfg)
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
