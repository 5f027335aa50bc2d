"""Quantitative evaluation of a trained model: port of
``ic_gan_tpu/cli/test.py`` (reference ``inference/test.py``).

    python -m ic_gan_tpu_torch.cli.test --json_config cfg.json [--set ...] \\
        [--device cuda]

IS and FID (and optionally PRDC and the ImageNet-LT stratified FIDs) over
``num_inception_images`` samples with the conditioning drawn from the HDF5
dataset under ``data_root``, against the moments file of
``eval.pipeline.moments_filename``; ``sample_trunc_curves`` sweeps z's
variance; ``metrics_out`` saves the metrics dict as an npy, ``sample_npz``
exports uint8 samples (N, 3, H, W) for an external eval (the reference's TF
path).  The generator comes from ``cli.inference.load_model_inference``.
Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import os

import numpy as np

from ic_gan_tpu_torch.cli.config import parse_args, split_config
from ic_gan_tpu_torch.cli.inference import (
    conditioning_flags,
    device_flag,
    load_model_inference,
    make_conditioned_sampler,
)


def nchw(sample):
    """A conditioned sampler (NHWC images) as the eval's ``sample_fn``
    (NCHW images)."""
    def sample_fn(b):
        imgs, labels = sample(b)
        return imgs.permute(0, 3, 1, 2), labels

    return sample_fn


def main(argv=None):
    from ic_gan_tpu_torch import resolve_device

    cfg = parse_args(argv)
    device = resolve_device(device_flag(argv))
    apply_fn, model_cfg = load_model_inference(cfg, device=device)

    from ic_gan_tpu_torch.data.datasets import get_dataset_hdf5
    from ic_gan_tpu_torch.eval.pipeline import (
        InceptionEvaluator,
        evaluate_generator,
        moments_filename,
    )

    data_kwargs = split_config(cfg, inference=True)[3]
    # The network decides the conditioning the dataset must serve (StyleGAN2
    # configs carry h_dim/c_dim, not BigGAN's class_cond/instance_cond).
    class_cond, instance_cond = conditioning_flags(cfg, model_cfg)
    data_kwargs["class_cond"] |= class_cond
    data_kwargs["instance_cond"] |= instance_cond
    dataset = get_dataset_hdf5(**data_kwargs, device=device)

    data_root = data_kwargs["data_path"]
    resolution = cfg.get("resolution", 64)
    ref = np.load(os.path.join(data_root, moments_filename(
        resolution, cfg.get("which_dataset", "imagenet"), cfg.get("longtail", False))))
    # eval_bf16: the bf16 Inception trunk (models/inception.py); keep it off
    # when comparing FIDs with float32-evaluated ones.
    evaluator = InceptionEvaluator(cfg.get("inception_weights"),
                                   deploy_bf16=cfg.get("eval_bf16", False), device=device)

    if cfg.get("accumulate_stats", False) and cfg.get("backbone", "biggan") == "biggan":
        # Standing batch-norm statistics before sampling (ref
        # train_fns.py:159-163 / utils.py:1679-1695; BigGAN only, StyleGAN2
        # has no batch norm).
        def _standing_cond(n):
            labels, feats = dataset.sample_conditioning_instance_balance(n)
            return labels if class_cond else None, feats if instance_cond else None

        apply_fn = apply_fn.with_standing_stats(_standing_cond)

    def make_sample(var):
        return make_conditioned_sampler(cfg, apply_fn, model_cfg, dataset, z_var=var)

    sample = make_sample(cfg.get("z_var", 1.0))
    num_images = cfg.get("num_inception_images", 50000)
    batch = cfg.get("eval_batch_size", 64)

    stratified = samples_per_class = None
    if cfg.get("stratified_moments", False):
        # ImageNet-LT many/low/few-shot strata (ref test.py and the
        # inception_utils stratified path): the per-stratum moments and the
        # samples-per-class table.
        stratified = {}
        for strat in ("many", "low", "few"):
            path = os.path.join(data_root, moments_filename(resolution, strat=strat))
            if os.path.exists(path):
                m = np.load(path)
                stratified[strat] = (m["mu"], m["sigma"])
        spc_path = cfg.get("samples_per_class_path", "")
        if spc_path and os.path.exists(spc_path):
            samples_per_class = np.load(spc_path, allow_pickle=True)

    prdc_ref = None
    if cfg.get("eval_prdc", False):
        # PRDC's real features (ref test.py:82-91), cached on disk by the
        # dataset's identity (ref metric_utils.py:245-268).
        from ic_gan_tpu_torch.eval.pipeline import cached_real_features

        prdc_ref = cached_real_features(
            dataset, evaluator, cache_dir=os.path.join(data_root, "feature_cache"),
            n_items=cfg.get("prdc_ref_images", 10000), batch=batch)

    # G and Inception in one function per batch (fused_eval, the default);
    # False runs the two stages apart.
    feature_fn = None
    if cfg.get("fused_eval", True):
        from ic_gan_tpu_torch.cli.inference import make_conditioned_feature_fn

        feature_fn = make_conditioned_feature_fn(sample, evaluator)

    metrics = evaluate_generator(
        nchw(sample), evaluator, ref["mu"], ref["sigma"], num_images=num_images, batch=batch,
        prdc_ref_features=prdc_ref, prdc_nearest_k=cfg.get("prdc_nearest_k", 5),
        stratified=stratified, samples_per_class=samples_per_class, feature_fn=feature_fn)
    print({k: round(float(v), 4) for k, v in metrics.items()})

    if cfg.get("sample_trunc_curves"):
        # Truncation curves (ref flag --sample_trunc_curves, utils.py:923-932):
        # a "start_step_end" sweep of z's variance, IS and FID at each point.
        start, step, end = (float(v) for v in str(cfg["sample_trunc_curves"]).split("_"))
        if step <= 0:
            raise ValueError(f"sample_trunc_curves step must be > 0, got {step}")
        curve = []
        var = start
        while var <= end + 1e-9:
            m = evaluate_generator(nchw(make_sample(var)), evaluator, ref["mu"], ref["sigma"],
                                   num_images=num_images, batch=batch)
            point = {"z_var": round(var, 6), **{k: float(v) for k, v in m.items()}}
            print(f"trunc z_var={var:.3f}: IS {point['IS_mean']:.3f} FID {point['FID']:.3f}")
            curve.append(point)
            var += step
        metrics = dict(metrics, trunc_curves=curve)

    out = cfg.get("metrics_out", "")
    if out:
        np.save(out, metrics, allow_pickle=True)

    if cfg.get("sample_npz", False):
        # Samples for the official TF-based eval (ref test.py:186-267).
        remaining = cfg.get("sample_num_npz", 50000)
        imgs_all = []
        while remaining > 0:
            b = min(batch, remaining)
            imgs, _ = sample(b)
            imgs_all.append(((imgs.float().cpu().numpy() + 1) / 2 * 255).astype(np.uint8))
            remaining -= b
        x = np.concatenate(imgs_all)
        npz_path = cfg.get("npz_path", "samples.npz")
        np.savez(npz_path, x=np.transpose(x, (0, 3, 1, 2)))
        print(f"wrote {len(x)} samples to {npz_path}")
    return metrics


if __name__ == "__main__":
    main()
