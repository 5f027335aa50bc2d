"""Metric registry: FID / KID / IS / PR / PPL, the StyleGAN2 metric suite.

Port of ``ic_gan_tpu/eval/metrics.py`` (reference ``stylegan2_ada_pytorch/
metrics/*``): the registry (``metric_main.py:30-41``), kernel inception
distance (``kernel_inception_distance.py``), perceptual path length
(``perceptual_path_length.py``) and precision/recall
(``precision_recall.py``).  Images are NCHW in [-1, 1]; feature extraction
goes through ``eval.pipeline.InceptionEvaluator``.

PPL's distances are a pure function of the endpoints and the interpolation
point (``ppl_distances``); ``compute_ppl`` draws those from a
``torch.Generator``.  The ``ppl_*`` entries measure LPIPS when the caller
passes a ``feature_fn`` (``make_lpips_feature_fn``, ``models/vgg.py``);
without one they measure pixel distance, as the JAX package does.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.eval.fid import frechet_distance, full_f32, inception_score
from ic_gan_tpu_torch.eval.prdc import compute_prdc

_METRICS: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    _METRICS[fn.__name__] = fn
    return fn


def is_valid_metric(name: str) -> bool:
    return name in _METRICS


def list_metrics():
    return list(_METRICS)


def calc_metric(metric: str, **kwargs) -> Dict[str, float]:
    """(ref ``metric_main.py:44-76``)."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric}")
    return _METRICS[metric](**kwargs)


# --- KID ---------------------------------------------------------------------


def kid_from_features(real, fake, num_subsets: int = 100, max_subset_size: int = 1000,
                      seed: int = 0) -> float:
    """Kernel inception distance with the reference's polynomial kernel and
    subset averaging (``kernel_inception_distance.py:25-46``), in float64 on
    the host; subsets from ``np.random.RandomState(seed)``."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    n = real.shape[1]
    m = min(min(real.shape[0], fake.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = fake[rng.choice(fake.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


# --- PPL ---------------------------------------------------------------------


def make_lpips_feature_fn(weights_path: Optional[str] = None, device=None) -> Callable:
    """LPIPS ``feature_fn`` for ``compute_ppl`` / the projector: NCHW images
    in [-1, 1] → LPIPS feature vectors on ``device`` (CUDA unless named),
    whose squared L2 difference is the LPIPS distance (the contract of the
    reference's ``vgg16(..., return_lpips=True)``,
    ``perceptual_path_length.py:112-116``).  Weights from ``weights_path``
    or ``$ICGAN_VGG16_WEIGHTS`` (``models/vgg.py``)."""
    from ic_gan_tpu_torch.models.vgg import LPIPSEvaluator

    return LPIPSEvaluator(weights_path, device=device).features


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation (ref ``perceptual_path_length.py:25-35``)."""
    a_n = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b_n = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    d = torch.sum(a_n * b_n, dim=-1, keepdim=True)
    p = t * torch.arccos(torch.clamp(d, -1, 1))
    c = b_n - d * a_n
    c = c / torch.linalg.norm(c, dim=-1, keepdim=True)
    return (a_n * torch.cos(p) + c * torch.sin(p)) * torch.linalg.norm(a, dim=-1, keepdim=True)


def _ppl_prepare_images(img: torch.Tensor, crop: bool) -> torch.Tensor:
    """The reference's image conditioning before LPIPS
    (``perceptual_path_length.py:88-107``), NCHW in [-1, 1]: an optional
    centre crop (rows 3c:7c, columns 2c:6c, c = H//8), a mean-pool
    downsample by the generator's resolution over 256 (the full resolution,
    even after the crop shrank the image), grayscale to RGB."""
    if img.shape[2] != img.shape[3]:
        raise ValueError(f"PPL needs square images, got {tuple(img.shape)}")
    g_resolution = img.shape[2]
    if crop:
        c = img.shape[2] // 8
        img = img[:, :, c * 3: c * 7, c * 2: c * 6]
    factor = g_resolution // 256
    if factor > 1:
        b, ch, h, w = img.shape
        img = img.reshape(b, ch, h // factor, factor, w // factor, factor).mean(dim=(3, 5))
    if img.shape[1] == 1:
        img = img.repeat(1, 3, 1, 1)
    return img


def ppl_distances(g_synthesize: Callable, map_ws: Callable, z0, z1, t, epsilon: float = 1e-4,
                  space: str = "w", crop: bool = False, feature_fn: Optional[Callable] = None,
                  cond: Optional[dict] = None, synth_kw: Optional[dict] = None
                  ) -> torch.Tensor:
    """Squared feature distances over ε² of the images at t and t + ε on the
    path from z0 to z1 (``PPLSampler.forward``, ``:60-72``): lerp in W for
    ``space="w"``, slerp in Z for ``"z"``.  ``t`` is (b, 1).  Pixel distance
    without a ``feature_fn``.  A ``generator`` in ``synth_kw`` draws the
    same noise for both images: its state is restored before the second
    synthesis, as the reference synthesizes the pair in one batch under one
    draw of its noise buffers (``:75-78``)."""
    cond, synth_kw = cond or {}, synth_kw or {}
    gen = synth_kw.get("generator")
    state = gen.get_state() if gen is not None else None

    def synth(ws, again=False):
        if again and gen is not None:
            gen.set_state(state)
        return g_synthesize(ws, **synth_kw)

    if space == "w":
        w0, w1 = map_ws(z0, **cond), map_ws(z1, **cond)
        tw = t[..., None]
        img0 = synth(w0 + (w1 - w0) * tw)
        img1 = synth(w0 + (w1 - w0) * (tw + epsilon), again=True)
    else:
        img0 = synth(map_ws(slerp(z0, z1, t), **cond))
        img1 = synth(map_ws(slerp(z0, z1, t + epsilon), **cond), again=True)
    img0, img1 = _ppl_prepare_images(img0, crop), _ppl_prepare_images(img1, crop)
    if feature_fn is not None:
        f0, f1 = feature_fn(img0), feature_fn(img1)
    else:
        f0, f1 = img0.reshape(img0.shape[0], -1), img1.reshape(img1.shape[0], -1)
    return torch.sum(torch.square(f0 - f1), dim=-1) / (epsilon ** 2)


_warned_pixel_ppl = False


def compute_ppl(
    g_synthesize: Callable,
    map_ws: Callable,
    z_dim: int,
    num_samples: int = 1000,
    epsilon: float = 1e-4,
    space: str = "w",
    sampling: str = "end",
    crop: bool = False,
    batch: int = 16,
    feature_fn: Optional[Callable] = None,
    cond_sampler: Optional[Callable] = None,
    seed: int = 0,
    device=None,
) -> Dict[str, object]:
    """Perceptual path length (ref ``perceptual_path_length.py:40-170``).

    ``sampling="full"`` draws t ~ U(0, 1), ``"end"`` takes t = 0
    (``:56-58``); z0, z1 and t come from a generator seeded ``seed`` on
    ``device`` (default CUDA).  The result is ``ppl_from_distances`` of
    ``ppl_distances``; ``"ppl_distance"`` says whether
    LPIPS (a ``feature_fn``) or pixels measured it.  Matmuls and
    convolutions run in full float32 (``eval.fid.full_f32``).  ``g_synthesize`` may
    take ``generator=``; it then gets the draws' generator, to redraw its
    noise each batch as the reference redraws ``noise_const`` (``:75-78``),
    the same noise for both images of a pair.
    """
    if space not in ("z", "w") or sampling not in ("full", "end"):
        raise ValueError(f"space {space!r}, sampling {sampling!r}")
    device = resolve_device(device)
    try:
        synth_takes_gen = "generator" in inspect.signature(g_synthesize).parameters
    except (TypeError, ValueError):
        synth_takes_gen = False

    global _warned_pixel_ppl
    if feature_fn is None and not _warned_pixel_ppl:
        warnings.warn(
            "PPL without LPIPS (no feature_fn, see make_lpips_feature_fn): pixel-space "
            "distance, self-consistent but not a perceptual path length in the reference's "
            "sense.",
            stacklevel=2)
        _warned_pixel_ppl = True

    gen = torch.Generator(device=device).manual_seed(seed)
    dists = []
    done = 0
    while done < num_samples:
        b = min(batch, num_samples - done)
        z0 = torch.randn((b, z_dim), generator=gen, device=device)
        z1 = torch.randn((b, z_dim), generator=gen, device=device)
        cond = cond_sampler(b) if cond_sampler is not None else {}
        if sampling == "full":
            t = torch.rand((b, 1), generator=gen, device=device)
        else:
            t = torch.zeros((b, 1), device=device)
        with torch.inference_mode(), full_f32():
            d = ppl_distances(g_synthesize, map_ws, z0, z1, t, epsilon, space, crop,
                              feature_fn, cond, {"generator": gen} if synth_takes_gen else {})
        dists.append(d.double().cpu().numpy())
        done += b
    return {"ppl": ppl_from_distances(np.concatenate(dists)),
            "ppl_distance": "lpips" if feature_fn is not None else "pixel"}


def ppl_from_distances(dist: np.ndarray) -> float:
    """The mean of the distances within the 1st and 99th percentiles, taken
    by the reference's lower and higher interpolation (``:166-170``)."""
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(dist[(dist >= lo) & (dist <= hi)].mean())


def ppl_w(g_synthesize, map_ws, z_dim, sampling: str = "full", **kw) -> float:
    """Scalar form of :func:`compute_ppl` (t ~ U(0, 1) by default)."""
    return compute_ppl(g_synthesize, map_ws, z_dim, sampling=sampling, **kw)["ppl"]


# --- registry entries (ref metric_main.py:98-241) ---------------------------
#
# All 12 of the reference's registered metrics: fid50k_full, kid50k_full,
# pr50k3_full, ppl2_wend, is50k (``:98-151``) and the legacy fid50k, kid50k,
# pr50k3, ppl_{z,w}{full,end} (``:155-241``).  Each entry's ``max_real`` is
# the reference's real-side sample cap (None: the whole dataset or the
# precomputed moments).


def _fake_pools(sample_fn, evaluator, num_images: int, batch: int) -> np.ndarray:
    """Generator-side Inception pool features for the feature-set metrics."""
    pools = []
    remaining = num_images
    while remaining > 0:
        b = min(batch, remaining)
        imgs, _ = sample_fn(b)
        pools.append(evaluator(imgs)[0])
        remaining -= b
    return np.concatenate(pools)


def _pr_entry(prefix, sample_fn, evaluator, real_features, num_images, batch, nearest_k):
    fake = _fake_pools(sample_fn, evaluator, num_images, batch)
    n = min(len(real_features), len(fake))
    out = compute_prdc(real_features[:n], fake[:n], nearest_k, device=evaluator.device)
    return {f"{prefix}_precision": out["precision"], f"{prefix}_recall": out["recall"]}


def _ppl_entry(name, sampling, space, crop, g_synthesize, map_ws, z_dim, kw):
    out = compute_ppl(g_synthesize, map_ws, z_dim, sampling=sampling, space=space,
                      crop=crop, **kw)
    return {name: out["ppl"], "ppl_distance": out["ppl_distance"]}


@register_metric
def fid50k_full(sample_fn=None, evaluator=None, ref_mu=None, ref_sigma=None,
                num_images: int = 50000, **kw):
    """FID against full-dataset precomputed moments (ref
    ``metric_main.py:98-104``: ``max_real=None``)."""
    from ic_gan_tpu_torch.eval.pipeline import evaluate_generator

    out = evaluate_generator(sample_fn, evaluator, ref_mu, ref_sigma,
                             num_images=num_images, **kw)
    return {"fid50k_full": out["FID"]}


@register_metric
def fid50k(sample_fn=None, evaluator=None, real_features=None, num_images: int = 50000,
           batch: int = 64, **kw):
    """Legacy FID: real moments from ≤ 50k real features (ref
    ``metric_main.py:158-162``: ``max_real=50000``)."""
    real = np.asarray(real_features[:50000], np.float64)
    fake = np.asarray(_fake_pools(sample_fn, evaluator, num_images, batch), np.float64)
    fid = frechet_distance(fake.mean(0), np.cov(fake, rowvar=False), real.mean(0),
                           np.cov(real, rowvar=False), device=evaluator.device)
    return {"fid50k": fid}


@register_metric
def kid50k_full(sample_fn=None, evaluator=None, real_features=None,
                num_images: int = 50000, batch: int = 64, **kw):
    """(ref ``metric_main.py:107-112``: ``max_real=1000000``)."""
    fake = _fake_pools(sample_fn, evaluator, num_images, batch)
    return {"kid50k_full": kid_from_features(real_features, fake, **kw)}


@register_metric
def kid50k(sample_fn=None, evaluator=None, real_features=None, num_images: int = 50000,
           batch: int = 64, **kw):
    """(ref ``metric_main.py:165-170``: ``max_real=50000``)."""
    fake = _fake_pools(sample_fn, evaluator, num_images, batch)
    return {"kid50k": kid_from_features(real_features[:50000], fake, **kw)}


@register_metric
def is50k(sample_fn=None, evaluator=None, num_images: int = 50000, batch: int = 64, **kw):
    """(ref ``metric_main.py:144-148``)."""
    logits = []
    remaining = num_images
    while remaining > 0:
        b = min(batch, remaining)
        imgs, _ = sample_fn(b)
        logits.append(evaluator(imgs)[1])
        remaining -= b
    m, s = inception_score(np.concatenate(logits))
    return {"is50k_mean": m, "is50k_std": s}


@register_metric
def pr50k3(sample_fn=None, evaluator=None, real_features=None, num_images: int = 50000,
           batch: int = 64, nearest_k: int = 3, **kw):
    """(ref ``metric_main.py:173-184``: ``max_real=50000``, nhood 3)."""
    return _pr_entry("pr50k3", sample_fn, evaluator, real_features[:50000],
                     num_images, batch, nearest_k)


@register_metric
def pr50k3_full(sample_fn=None, evaluator=None, real_features=None,
                num_images: int = 50000, batch: int = 64, nearest_k: int = 3, **kw):
    """(ref ``metric_main.py:115-126``: ``max_real=200000``, nhood 3)."""
    return _pr_entry("pr50k3_full", sample_fn, evaluator, real_features,
                     num_images, batch, nearest_k)


@register_metric
def ppl2_wend(g_synthesize=None, map_ws=None, z_dim=None, **kw):
    """(ref ``metric_main.py:129-141``: w space, end sampling, no crop)."""
    return _ppl_entry("ppl2_wend", "end", "w", False, g_synthesize, map_ws, z_dim, kw)


@register_metric
def ppl_zfull(g_synthesize=None, map_ws=None, z_dim=None, **kw):
    """(ref ``metric_main.py:187-199``: z space, full sampling, crop)."""
    return _ppl_entry("ppl_zfull", "full", "z", True, g_synthesize, map_ws, z_dim, kw)


@register_metric
def ppl_wfull(g_synthesize=None, map_ws=None, z_dim=None, **kw):
    """(ref ``metric_main.py:202-214``: w space, full sampling, crop)."""
    return _ppl_entry("ppl_wfull", "full", "w", True, g_synthesize, map_ws, z_dim, kw)


@register_metric
def ppl_zend(g_synthesize=None, map_ws=None, z_dim=None, **kw):
    """(ref ``metric_main.py:217-229``: z space, end sampling, crop)."""
    return _ppl_entry("ppl_zend", "end", "z", True, g_synthesize, map_ws, z_dim, kw)


@register_metric
def ppl_wend(g_synthesize=None, map_ws=None, z_dim=None, **kw):
    """(ref ``metric_main.py:232-241``: w space, end sampling, crop)."""
    return _ppl_entry("ppl_wend", "end", "w", True, g_synthesize, map_ws, z_dim, kw)


# Real-side sample caps from the reference registrations, for an eval CLI.
for _name, _cap in {
    "fid50k_full": None, "kid50k_full": 1000000, "pr50k3_full": 200000,
    "ppl2_wend": 0, "is50k": 0, "fid50k": 50000, "kid50k": 50000,
    "pr50k3": 50000, "ppl_zfull": 0, "ppl_wfull": 0, "ppl_zend": 0,
    "ppl_wend": 0,
}.items():
    _METRICS[_name].max_real = _cap
