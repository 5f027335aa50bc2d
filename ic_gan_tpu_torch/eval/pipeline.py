"""The eval pipeline: Inception features → IS / FID / stratified FID / PRDC.

Port of ``ic_gan_tpu/eval/pipeline.py`` (reference ``data_utils/
inception_utils.py:289-455`` and ``calculate_inception_moments.py``).
Images are NCHW in [-1, 1], as the port's generators give them.  In the
device branch of ``evaluate_generator`` the pool features and logits stay
on the device and one ``fid_is_device`` tail runs at the end; the host
branch accumulates float64 moments on the host.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.data.loader import normalize_batch
from ic_gan_tpu_torch.eval.fid import (
    FeatureMoments,
    fid_is_device,
    frechet_distance,
    inception_score,
    to_host,
)
from ic_gan_tpu_torch.eval.prdc import compute_prdc
from ic_gan_tpu_torch.io.deploy import padded_rows
from ic_gan_tpu_torch.models.inception import InceptionV3, load_torch_inception
from ic_gan_tpu_torch.parallel import collectives
from ic_gan_tpu_torch.parallel.mesh import shard_rows


def moments_filename(resolution, which_dataset="imagenet", longtail=False,
                     split="train", test_part=False, strat=""):
    """``I64_inception_moments.npz`` convention
    (``calculate_inception_moments.py:170-192``)."""
    prefix = {"imagenet": "I", "imagenet_lt": "I", "coco": "COCO"}.get(
        which_dataset, which_dataset
    )
    if strat:
        return f"{prefix}{resolution}__val_{strat}_inception_moments.npz"
    return "%s%i%s%s%s_inception_moments.npz" % (
        prefix,
        resolution,
        "longtail" if longtail else "",
        "_val" if split == "val" else "",
        "_test" if test_part else "",
    )


class InceptionEvaluator:
    """InceptionV3 feature extractor on ``device`` (default CUDA).

    ``weights_path`` may name a torchvision ``inception_v3`` state dict
    (``.pth``); without one the net runs with random weights, drawn on the
    CPU from a generator seeded 0 and so the same on every device: the
    pipeline runs, but its FIDs are only self-consistent, not comparable
    with published ones.  ``deploy_bf16``
    runs the trunk's convs in bfloat16 (``models/inception.py``).  With
    ``mesh`` (``parallel.mesh``) each rank runs its share of a batch, the
    tail padded with zero rows to a multiple of the ranks as the JAX
    package pads it, and every rank returns the whole batch's features.
    """

    # evaluate_generator reads this to keep the features on the device.
    supports_device_output = True
    mesh = None

    def __init__(self, weights_path: Optional[str] = None, mesh=None,
                 deploy_bf16: bool = False, device=None):
        if mesh is not None and not mesh.holds_share:
            raise ValueError("this rank holds no share of the mesh")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.net = InceptionV3(
            dtype=torch.bfloat16 if deploy_bf16 else torch.float32, device="cpu",
            generator=torch.Generator().manual_seed(0)).to(self.device)
        self.pretrained = bool(weights_path and os.path.exists(weights_path))
        if self.pretrained:
            sd = torch.load(weights_path, map_location="cpu", weights_only=True)
            self.net.load_state_dict(load_torch_inception(sd))
        self.net.eval().requires_grad_(False)

    def __call__(self, images, device_output: bool = False):
        """images: NCHW in [-1, 1] → (pool (N, 2048), logits (N, 1000)),
        float32: numpy arrays, or with ``device_output`` tensors left on the
        device."""
        with torch.inference_mode():
            x = torch.as_tensor(images, device=self.device)
            if self.mesh is None:
                pool, logits = self.net(x)
            else:
                n = x.shape[0]
                x = torch.cat([x, x.new_zeros(((-n) % self.mesh.world,) + x.shape[1:])])
                pool, logits = (collectives.all_gather(t, self.mesh)[:n]
                                for t in self.net(shard_rows(x, self.mesh)))
        if device_output:
            return pool, logits
        return pool.cpu().numpy(), logits.cpu().numpy()

    def accumulate(self, image_iter: Iterable) -> Tuple[np.ndarray, np.ndarray]:
        pools, logits = [], []
        for imgs in image_iter:
            p, lg = self(imgs)
            pools.append(p)
            logits.append(lg)
        return np.concatenate(pools), np.concatenate(logits)


def _real_batches(dataset, idxs_all, n: int, batch: int, device):
    """Real images of the first ``n`` indices in batches on ``device``,
    normalized as the JAX package normalizes them (``HDF5Dataset._norm``'s
    formula through ``data.loader``)."""
    for lo in range(0, n, batch):
        idxs = idxs_all[lo: min(lo + batch, n)]
        yield idxs, normalize_batch(dataset._get_images(idxs), None,
                                    getattr(dataset, "apply_norm", True), device=device,
                                    formula="norm")


def compute_dataset_moments(
    dataset,
    evaluator: InceptionEvaluator,
    batch: int = 64,
    max_items: Optional[int] = None,
    samples_per_class: Optional[np.ndarray] = None,
):
    """Reference moments over a dataset (``calculate_inception_moments.py``).

    Returns ``{"": (mu, sigma, IS)}`` plus ``"many"/"low"/"few"`` strata when
    ``samples_per_class`` is given (ImageNet-LT).
    """
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    pools, logits, labels = [], [], []
    for idxs, imgs in _real_batches(dataset, dataset.possible_sampling_idxs, n, batch,
                                     evaluator.device):
        p, lg = evaluator(imgs)
        pools.append(p)
        logits.append(lg)
        labels.append(dataset.get_label(idxs))
    pool = np.concatenate(pools)
    logit = np.concatenate(logits)
    label = np.concatenate(labels)

    def stats(p, lg):
        return np.mean(p, axis=0), np.cov(p, rowvar=False), inception_score(lg)

    out = {"": stats(pool, logit)}
    if samples_per_class is not None:
        spc = samples_per_class[label]
        out["many"] = stats(pool[spc >= 100], logit[spc >= 100])
        mid = (spc < 100) & (spc > 20)
        out["low"] = stats(pool[mid], logit[mid])
        out["few"] = stats(pool[spc <= 20], logit[spc <= 20])
    return out


def save_moments(out_path: str, name: str, mu, sigma):
    np.savez(os.path.join(out_path, name), mu=mu, sigma=sigma)


def cached_real_features(
    dataset,
    evaluator: InceptionEvaluator,
    cache_dir: str,
    n_items: int,
    batch: int = 64,
) -> np.ndarray:
    """Real-side Inception pool features, cached on disk under an md5 of the
    dataset's identity, the evaluator's weights and its compute dtype (ref
    ``metric_utils.py:245-268``), written atomically with ``os.replace``."""
    idxs_all = np.asarray(dataset.possible_sampling_idxs)
    n = min(n_items, len(idxs_all))
    key_src = repr((
        getattr(dataset, "root", ""),
        getattr(dataset, "root_feats", ""),
        n,
        int(idxs_all[:n].sum()),
        hashlib.md5(idxs_all[:n].tobytes()).hexdigest(),
        evaluator.pretrained,
        # The compute dtype is part of the features' identity: bf16 moves
        # them by about 1 % (mean) of their size.
        str(evaluator.net.dtype).removeprefix("torch."),
        # The port's random weights are not the JAX package's: a cache of
        # either must not serve the other.
        "ic_gan_tpu_torch",
    )).encode()
    tag = hashlib.md5(key_src).hexdigest()[:16]
    path = os.path.join(cache_dir, f"real-pool-{tag}.npz")
    if os.path.exists(path):
        return np.load(path)["pool"]
    pool = np.concatenate([evaluator(imgs)[0]
                           for _, imgs in _real_batches(dataset, idxs_all, n, batch,
                                                        evaluator.device)])
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, pool=pool)
    os.replace(tmp, path)
    return pool


def make_fused_feature_fn(sampler, evaluator: InceptionEvaluator) -> Callable:
    """G and Inception in one function: ``feature_fn(z, label=None,
    feats=None) -> (pool, logits)``, left on the device, with no host sync
    per batch (give z, labels and features as device tensors).

    ``sampler`` comes from ``io.deploy.make_sampler`` (its ``module`` and
    ``apply_kwargs``), in the sampler's batches, the tail padded with
    copies of its first row as the sampler pads it."""
    g, apply_kwargs = sampler.module, sampler.apply_kwargs
    net, device = evaluator.net, evaluator.device

    def feature_fn(z, label=None, feats=None):
        n = z.shape[0]
        chunk = sampler.batch_size or n
        pools, logits = [], []
        with torch.inference_mode():
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                pad = chunk - (hi - lo)
                imgs = g(*(padded_rows(a, lo, hi, pad, device) for a in (z, label, feats)),
                         **apply_kwargs)
                pool, logit = net(imgs)
                pools.append(pool[: hi - lo])
                logits.append(logit[: hi - lo])
        if len(pools) == 1:
            return pools[0], logits[0]
        return torch.cat(pools), torch.cat(logits)

    return feature_fn


def evaluate_generator(
    sample_fn: Callable[[int], Tuple[object, Optional[np.ndarray]]],
    evaluator: InceptionEvaluator,
    ref_mu: np.ndarray,
    ref_sigma: np.ndarray,
    num_images: int = 50000,
    batch: int = 64,
    num_splits: int = 10,
    prdc_ref_features: Optional[np.ndarray] = None,
    prdc_nearest_k: int = 5,
    stratified: Optional[Dict] = None,
    samples_per_class: Optional[np.ndarray] = None,
    feature_fn: Optional[Callable] = None,
) -> Dict[str, float]:
    """Full quantitative eval (ref ``inception_utils.py:342-455`` and
    ``compute_pdrc.py``): IS over ``num_splits`` splits, FID against the
    reference moments, optionally PRDC and stratified FID.

    ``sample_fn(b) -> (images NCHW in [-1, 1], labels or None)``, or
    ``feature_fn(b) -> (pool, logits, labels)`` in its place (see
    ``make_fused_feature_fn``), for which ``evaluator`` only says whether
    features may stay on the device.  Labels may be tensors on the device:
    they are fetched only for the stratified FID.  Metrics run on the
    evaluator's device.
    """
    keep_pools = prdc_ref_features is not None or stratified is not None
    on_device = bool(getattr(evaluator, "supports_device_output", False))
    device = getattr(evaluator, "device", None)
    logits_all, labels_all, pools_all = [], [], []

    def next_batch(b):
        if feature_fn is not None:
            return feature_fn(b)
        imgs, labels = sample_fn(b)
        pool, logits = evaluator(imgs, device_output=on_device)
        return pool, logits, labels

    if on_device:
        # No host sync per batch: pools and logits stay on the device and
        # the whole metric tail runs once at the end.
        device_pools = []
        remaining = num_images
        while remaining > 0:
            b = min(batch, remaining)
            pool, logits, labels = next_batch(b)
            logits_all.append(logits)
            device_pools.append(pool)
            if labels is not None:
                labels_all.append(labels)
            remaining -= b
        pool_cat = torch.cat(device_pools)
        logits_cat = torch.cat(logits_all)
        del device_pools, logits_all
        fid_d, is_m, is_s = fid_is_device(pool_cat, logits_cat, ref_mu, ref_sigma,
                                          num_splits=num_splits)
        if keep_pools:
            pools_all = [pool_cat.cpu().numpy()]
        fid, is_mean, is_std = float(fid_d), float(is_m), float(is_s)
        del pool_cat, logits_cat
    else:
        moments = None
        remaining = num_images
        while remaining > 0:
            b = min(batch, remaining)
            pool, logits, labels = next_batch(b)
            pool, logits = to_host(pool), to_host(logits)
            if moments is None:
                moments = FeatureMoments(pool.shape[1])
            moments.update(pool)
            logits_all.append(logits)
            if keep_pools:
                pools_all.append(pool)
            if labels is not None:
                labels_all.append(labels)
            remaining -= b
        logits_cat = np.concatenate(logits_all)
        is_mean, is_std = inception_score(logits_cat, num_splits=num_splits)
        fid = frechet_distance(moments.mean, moments.cov, ref_mu, ref_sigma, device=device)

    out = {"IS_mean": is_mean, "IS_std": is_std, "FID": fid}

    if stratified is not None and labels_all and samples_per_class is not None:
        pool_cat = np.concatenate(pools_all)
        spc = samples_per_class[np.concatenate([to_host(lab) for lab in labels_all])]
        masks = {
            "many": spc >= 100,
            "low": (spc < 100) & (spc > 20),
            "few": spc <= 20,
        }
        for name, mask in masks.items():
            if name in stratified and mask.sum() > 1:
                ref_mu_s, ref_sig_s = stratified[name]
                out[f"FID_{name}"] = frechet_distance(
                    np.mean(pool_cat[mask], axis=0), np.cov(pool_cat[mask], rowvar=False),
                    ref_mu_s, ref_sig_s, device=device)

    if prdc_ref_features is not None:
        pool_cat = np.concatenate(pools_all)
        k = min(len(prdc_ref_features), len(pool_cat))
        out.update(compute_prdc(prdc_ref_features[:k], pool_cat[:k], prdc_nearest_k,
                                device=device))
    return out


def make_train_eval_fn(cfg: Dict, device=None, seed: int = 1000,
                       draw: Optional[Callable] = None):
    """The trainers' ``eval_fn`` from a flat config (``cli/train.py``,
    ``cli/train_stylegan2.py``): the reference moments npz under
    ``data_root`` (``FileNotFoundError`` when it is missing), an
    ``InceptionEvaluator`` on ``device`` (default CUDA) and
    ``num_inception_images`` EMA samples in batches of ``eval_batch_size``.

    ``draw(trainer, b, generator) -> (images, labels)`` takes a batch from
    the trainer (default: the BigGAN ``Trainer.sample_fn`` of the EMA G).
    Each eval draws z from generators seeded ``seed`` + the batch's count on
    the trainer's device, and the conditioning from a stream seeded
    ``seed`` that stands in for the dataset's own during the eval: the same
    inputs at every eval, and the sampler's stream left where the last
    snapshot recorded it, so a resumed run draws the batches a straight run
    does (the JAX package draws it from the sampler's stream: ROADMAP.md
    §C)."""
    data_root = cfg.get("data_root", cfg.get("data_path", "data"))
    name = moments_filename(
        cfg.get("resolution", 64),
        cfg.get("which_dataset", "imagenet"),
        cfg.get("longtail", False),
    )
    path = os.path.join(data_root, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"reference moments not found: {path}")
    ref = np.load(path)
    evaluator = InceptionEvaluator(cfg.get("inception_weights"),
                                   deploy_bf16=cfg.get("eval_bf16", False), device=device)
    num_images = cfg.get("num_inception_images", 50000)
    eval_batch = cfg.get("eval_batch_size", 64)
    draw = draw or (lambda trainer, b, gen: trainer.sample_fn(b, gen, use_ema=True)[:2])

    def eval_fn(trainer):
        counter = [0]

        def sample(b):
            counter[0] += 1
            return draw(trainer, b,
                        torch.Generator(device=trainer.device).manual_seed(seed + counter[0]))

        dataset = trainer.dataset
        live, dataset.rng = dataset.rng, np.random.default_rng(seed)
        try:
            return evaluate_generator(sample, evaluator, ref["mu"], ref["sigma"],
                                      num_images=num_images, batch=eval_batch)
        finally:
            dataset.rng = live

    return eval_fn
