"""Quality metrics of a trained network: port of
``ic_gan_tpu/cli/calc_metrics.py`` (reference
``stylegan2_ada_pytorch/calc_metrics.py``).

    python -m ic_gan_tpu_torch.cli.calc_metrics --json_config cfg.json \\
        --set metrics=fid50k_full,is50k [--device cuda]

Metric names follow the reference registry (``metrics/metric_main.py:
98-241``), all 12: ``fid50k_full``, ``kid50k_full``, ``pr50k3_full``,
``ppl2_wend``, ``is50k`` and the legacy ``fid50k``, ``kid50k``, ``pr50k3``,
``ppl_zfull``, ``ppl_wfull``, ``ppl_zend``, ``ppl_wend``.  The real-side
feature counts honour each entry's ``max_real`` cap, bounded by
``max_real_images`` (default ``num_inception_images`` up to 10,000).  The
network comes from any source of ``cli.inference.load_model_inference``;
sample counts follow ``num_inception_images`` (PPL's ``ppl_num_samples``).
PPL measures LPIPS with the VGG16 file named by ``$ICGAN_VGG16_WEIGHTS``,
else pixel distance.  The results print as one dict and append to
``metric-<name>.jsonl`` in ``run_dir`` when it is set (ref
``calc_metrics.py:90-106``, ``metric_main.py:49-76``).  Runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ic_gan_tpu_torch.cli.config import parse_args, split_config
from ic_gan_tpu_torch.cli.inference import (
    conditioning_flags,
    device_flag,
    load_model_inference,
    make_conditioned_sampler,
)
from ic_gan_tpu_torch.cli.test import nchw

# The five PPL registry entries share one setup (space, sampling and crop are
# the registry's); every other metric needs the Inception evaluator.
PPL_METRICS = ("ppl2_wend", "ppl_zfull", "ppl_wfull", "ppl_zend", "ppl_wend")


def main(argv=None):
    from ic_gan_tpu_torch import resolve_device
    from ic_gan_tpu_torch.eval.metrics import _METRICS, calc_metric, is_valid_metric

    cfg = parse_args(argv)
    device = resolve_device(device_flag(argv))
    names = [m.strip() for m in str(cfg.get("metrics", "fid50k_full")).split(",") if m.strip()]
    for m in names:
        if not is_valid_metric(m):
            raise ValueError(f"unknown metric {m}")

    apply_fn, model_cfg = load_model_inference(cfg, device=device)
    num_images = cfg.get("num_inception_images", 50000)
    batch = cfg.get("eval_batch_size", 64)
    class_cond, instance_cond = conditioning_flags(cfg, model_cfg)

    dataset = None
    data_kwargs = split_config(cfg, inference=True)[3]
    data_root = data_kwargs.get("data_path")
    # PPL alone needs no Inception or moments, but a conditional network
    # still needs the dataset to draw its (c, h) endpoints.
    needs_inception = any(m not in PPL_METRICS for m in names)
    if needs_inception or class_cond or instance_cond:
        from ic_gan_tpu_torch.data.datasets import get_dataset_hdf5

        # The network decides the conditioning the dataset must serve.
        data_kwargs["class_cond"] |= class_cond
        data_kwargs["instance_cond"] |= instance_cond
        dataset = get_dataset_hdf5(**data_kwargs, device=device)

    evaluator = None
    if needs_inception:
        from ic_gan_tpu_torch.eval.pipeline import InceptionEvaluator

        evaluator = InceptionEvaluator(cfg.get("inception_weights"),
                                       deploy_bf16=cfg.get("eval_bf16", False), device=device)
    sample = nchw(make_conditioned_sampler(cfg, apply_fn, model_cfg, dataset))

    real_cache: Dict[object, np.ndarray] = {}

    def real_features(max_real):
        """Real-side pool features under the registry's ``max_real`` cap (ref
        ``metric_main.py:107-184``), bounded by ``max_real_images``
        (``prdc_ref_images`` its older name)."""
        bound = cfg.get("max_real_images", cfg.get("prdc_ref_images", min(num_images, 10000)))
        n = bound if max_real is None else min(max_real, bound)
        if n not in real_cache:
            from ic_gan_tpu_torch.eval.pipeline import cached_real_features

            real_cache[n] = cached_real_features(
                dataset, evaluator, cache_dir=os.path.join(data_root, "feature_cache"),
                n_items=n, batch=batch)
        return real_cache[n]

    def ppl_kwargs():
        """The five PPL entries' setup (ref ``perceptual_path_length.py:
        40-92``): the StyleGAN2 mapping and synthesis, random noise drawn
        from ``compute_ppl``'s generator each batch and shared by the pair
        (the reference redraws ``noise_const``, ``:75-78``), LPIPS from
        ``$ICGAN_VGG16_WEIGHTS``."""
        if cfg.get("backbone") != "stylegan2":
            raise ValueError("PPL metrics need the stylegan2 backbone")
        from ic_gan_tpu_torch.eval.metrics import make_lpips_feature_fn

        g = apply_fn.module

        def map_fn(z, c=None, feats=None):
            return g.map_ws(z, c, feats)

        def synth_fn(ws, generator=None):
            return g.synthesize(ws, noise_mode="random", generator=generator)

        cond_sampler = None
        if class_cond or instance_cond:
            # Conditional endpoints come from the dataset, as the reference's
            # generator statistics draw them (metric_utils.py:368-388).
            def cond_sampler(b):
                lab, feats = dataset.sample_conditioning_instance_balance(b)
                cond = {}
                if instance_cond:
                    cond["feats"] = torch.as_tensor(feats, device=device)
                if class_cond and lab is not None:
                    c = torch.as_tensor(lab, device=device)
                    if c.dim() == 1:
                        c = F.one_hot(c, model_cfg.c_dim).float()
                    cond["c"] = c
                return cond

        feature_fn = None
        if os.environ.get("ICGAN_VGG16_WEIGHTS"):
            feature_fn = make_lpips_feature_fn(os.environ["ICGAN_VGG16_WEIGHTS"], device=device)
        return dict(g_synthesize=synth_fn, map_ws=map_fn, z_dim=model_cfg.z_dim,
                    num_samples=cfg.get("ppl_num_samples", min(num_images, 2000)),
                    batch=batch, feature_fn=feature_fn, cond_sampler=cond_sampler,
                    device=device)

    results = {}
    for name in names:
        kw = dict(num_images=num_images, batch=batch)
        if name == "fid50k_full":
            from ic_gan_tpu_torch.eval.pipeline import moments_filename

            ref = np.load(os.path.join(data_root, moments_filename(
                cfg.get("resolution", 64), cfg.get("which_dataset", "imagenet"),
                cfg.get("longtail", False))))
            kw.update(evaluator=evaluator, sample_fn=sample, ref_mu=ref["mu"],
                      ref_sigma=ref["sigma"])
        elif name in ("fid50k", "kid50k_full", "kid50k", "pr50k3", "pr50k3_full"):
            kw.update(evaluator=evaluator, sample_fn=sample,
                      real_features=real_features(_METRICS[name].max_real))
        elif name == "is50k":
            kw.update(evaluator=evaluator, sample_fn=sample)
        else:
            kw = ppl_kwargs()
        out = calc_metric(name, **kw)
        results.update(out)
        run_dir = cfg.get("run_dir", "")
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, f"metric-{name}.jsonl"), "a") as f:
                f.write(json.dumps(
                    {"results": {k: (v if isinstance(v, str) else float(v))
                                 for k, v in out.items()},
                     "metric": name, "total_images": num_images,
                     "timestamp": time.time()}) + "\n")

    print({k: (v if isinstance(v, str) else round(float(v), 4)) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
