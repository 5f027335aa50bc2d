"""The port's eval stack (``eval/fid.py``, ``prdc.py``, ``metrics.py``,
``pipeline.py``) and its wiring into both training CLIs, against the JAX
package, on the CPU.

- The metric pieces at dimension 64-256 from numpy seeds: moments, the
  Newton-Schulz square root, FID in both of its branches (the same branch on
  both sides), IS on the host and on the device, the one-call tail; PRDC,
  KID; PPL's slerp, image conditioning and distances on JAX's draws.
- ``evaluate_generator`` in both branches, with PRDC and stratified FID,
  on the same 16 seeded images through seeded random Inception weights
  saved as a torchvision ``.pth`` that both packages' evaluators load; the
  real-side moments and feature cache over an HDF5 set through
  ``HDF5Dataset._norm``.
- ``cli/train.py`` with reference moments under ``data_root``: the trainer
  evaluates, saves its best copy and logs the metrics, and resumes bit for
  bit; without the file the CLI says eval is disabled.
  ``cli/train_stylegan2.py``'s snapshot eval.

No FID tail here runs at Inception's full 2048 features: each costs 15-25
core-seconds on a CPU (Newton-Schulz's 150 products of 2048³), and the
card holds that width (``tests/test_torch_port_cuda.py``).
``evaluate_generator`` is compared on the pool's first 256 features, and
the CLI tests take the exact float64 trace of their low-rank covariances.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.eval import fid as jfid
from ic_gan_tpu.eval import metrics as jmetrics
from ic_gan_tpu.eval import pipeline as jpipe
from ic_gan_tpu.eval import prdc as jprdc
from ic_gan_tpu_torch.cli import train as tcli
from ic_gan_tpu_torch.cli import train_stylegan2 as tsg2cli
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.eval import fid as tfid
from ic_gan_tpu_torch.eval import metrics as tmetrics
from ic_gan_tpu_torch.eval import pipeline as tpipe
from ic_gan_tpu_torch.eval import prdc as tprdc
from ic_gan_tpu_torch.models import inception as tinception
from test_torch_port_biggan_loop import K, RES, _cli_config, _state_tensors, files  # noqa: F401
from test_torch_port_classcond import _one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _features(n, dim, seed):
    """Non-negative features of varied scale, like pool3's."""
    rng = np.random.RandomState(seed)
    return (np.maximum(rng.randn(n, dim), 0) * rng.uniform(0.5, 2.0, dim)).astype(np.float32)


def _ref_moments(dim, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim // 4)
    return rng.randn(dim) * 0.1, a @ a.T / dim + 0.1 * np.eye(dim)


def _jax_ns_branch(s1, s2):
    """Whether the JAX FID takes its eigenvalue path: its Newton-Schulz trace
    is not finite."""
    tr = jnp.trace(jfid.sqrtm_newton_schulz(jnp.asarray(s1 @ s2, jnp.float32)))
    return not bool(jnp.isfinite(tr))


# --- the metric pieces -------------------------------------------------------------

def test_feature_moments_and_newton_schulz_match_jax():
    f = _features(300, 96, 0)
    jm, tm = jfid.FeatureMoments(96), tfid.FeatureMoments(96)
    for lo in range(0, 300, 128):
        jm.update(f[lo:lo + 128])
        tm.update(torch.from_numpy(f[lo:lo + 128]))
    assert tm.n == jm.n == 300
    np.testing.assert_allclose(tm.mean, jm.mean, rtol=1e-10)
    np.testing.assert_allclose(tm.cov, jm.cov, rtol=1e-10, atol=1e-12)
    s2 = _ref_moments(96, 1)[1]
    prod = (jm.cov @ s2).astype(np.float32)
    want = np.asarray(jfid.sqrtm_newton_schulz(jnp.asarray(prod)))
    got = tfid.sqrtm_newton_schulz(torch.from_numpy(prod)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n,dim,eigh", [(1000, 64, False), (16, 128, True), (24, 256, True)])
def test_frechet_distance_matches_jax_in_both_branches(n, dim, eigh):
    """Full rank (n ≫ dim): Newton-Schulz; rank-deficient (n ≪ dim): it goes
    non-finite and the eigenvalue path gives the trace, on both sides."""
    f = _features(n, dim, 2).astype(np.float64)
    mu1, s1 = f.mean(0), np.cov(f, rowvar=False)
    mu2, s2 = _ref_moments(dim, 3)
    _, used_eigh = tfid.trace_sqrtm_product(torch.tensor(s1, dtype=torch.float32),
                                            torch.tensor(s2, dtype=torch.float32))
    assert used_eigh == _jax_ns_branch(s1, s2) == eigh
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert _rel(tfid.frechet_distance(mu1, s1, mu2, s2, device="cpu"), want) < 1e-4
    m = tfid.FeatureMoments(dim)
    m.update(f)
    assert _rel(tfid.compute_fid_from_moments(m, mu2, s2, device="cpu"), want) < 1e-4
    # The one-call tail, with IS over logits of 10 classes.
    logits = np.random.RandomState(4).randn(n, 10).astype(np.float32) * 3
    jf, jis, jstd = jfid.fid_is_device(jnp.asarray(f, jnp.float32), jnp.asarray(logits),
                                       jnp.asarray(mu2, jnp.float32),
                                       jnp.asarray(s2, jnp.float32), num_splits=4)
    tf_, tis, tstd = tfid.fid_is_device(torch.tensor(f, dtype=torch.float32),
                                        torch.from_numpy(logits), mu2, s2, num_splits=4)
    assert tf_.dim() == 0 and _rel(tf_, jf) < 1e-4
    assert _rel(tis, jis) < 1e-4 and _rel(tstd, jstd) < 1e-4


def test_inception_score_matches_jax():
    logits = np.random.RandomState(5).randn(37, 20).astype(np.float32) * 4
    for from_logits in (True, False):
        x = logits if from_logits else np.asarray(jax.nn.softmax(logits, axis=1))
        want = jfid.inception_score(x, num_splits=5, from_logits=from_logits)
        got = tfid.inception_score(torch.from_numpy(x), num_splits=5, from_logits=from_logits)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    jm, js = jfid.inception_score_device(jnp.asarray(logits), num_splits=5)
    tm, ts = tfid.inception_score_device(torch.from_numpy(logits), num_splits=5)
    assert _rel(tm, jm) < 1e-4 and _rel(ts, js) < 1e-4
    assert tfid.inception_score(logits[:3], num_splits=10) == jfid.inception_score(
        logits[:3], num_splits=10)  # splits capped at n


@pytest.mark.parametrize("setting", ["legacy allow_tf32", "generic high", "new cuda tf32"])
def test_full_f32_matmul_restores_the_callers_setting(setting):
    """Inside: full f32 on every backend, consistently (the legacy getter
    reads it); after: the caller's settings exactly, however they were made
    (a setting made by the new API alone leaves the generic one unreadable,
    and the block must not touch it then)."""
    cuda, mkldnn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    saved = (torch.get_float32_matmul_precision(), cuda.fp32_precision, mkldnn.fp32_precision)
    try:
        if setting == "legacy allow_tf32":
            cuda.allow_tf32 = True
        elif setting == "generic high":
            torch.set_float32_matmul_precision("high")
        else:
            cuda.fp32_precision = "tf32"
        before = (cuda.fp32_precision, mkldnn.fp32_precision)
        with tfid.full_f32_matmul():
            assert (cuda.fp32_precision, mkldnn.fp32_precision) == ("ieee", "ieee")
            assert not cuda.allow_tf32 and torch.get_float32_matmul_precision() == "highest"
        assert (cuda.fp32_precision, mkldnn.fp32_precision) == before == (
            "tf32", "tf32" if setting == "generic high" else "none")
        if setting != "new cuda tf32":
            assert cuda.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cuda.fp32_precision, mkldnn.fp32_precision = saved[1:]


def test_prdc_and_kid_match_jax():
    real, fake = _features(64, 16, 6), _features(48, 16, 7) + 0.1
    for k in (3, 5):
        want = jprdc.compute_prdc(real, fake, k)
        got = tprdc.compute_prdc(real, fake, k, device="cpu")
        assert got == want and 0 < got["precision"] < 1 and 0 < got["coverage"] < 1
    np.testing.assert_allclose(
        tprdc.knn_radii(torch.from_numpy(real), 3).numpy(),
        np.asarray(jprdc.knn_radii(jnp.asarray(real), 3)), rtol=1e-5)
    want = jmetrics.kid_from_features(real, fake, num_subsets=7, max_subset_size=40, seed=2)
    got = tmetrics.kid_from_features(real, fake, num_subsets=7, max_subset_size=40, seed=2)
    assert abs(got - want) < 1e-10


# --- PPL ----------------------------------------------------------------------------

Z, WS, WD, PRES = 6, 3, 5, 16


def _ppl_nets(seed=8):
    """A toy mapping (z → ws) and synthesis (ws → NHWC in JAX, NCHW in the
    port), float64, from one set of numpy weights."""
    rng = np.random.RandomState(seed)
    w1, w2 = rng.randn(Z, WS * WD), rng.randn(WD, 3 * PRES * PRES) / np.sqrt(WD)

    @jax.jit
    def jmap(z):
        return jnp.tanh(z @ w1).reshape(z.shape[0], WS, WD)

    @jax.jit
    def jsynth(ws):
        return jnp.tanh(ws.mean(1) @ w2).reshape(ws.shape[0], 3, PRES, PRES).transpose(0, 2, 3, 1)

    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)

    def tmap(z):
        return torch.tanh(z @ tw1).reshape(z.shape[0], WS, WD)

    def tsynth(ws):
        return torch.tanh(ws.mean(1) @ tw2).reshape(ws.shape[0], 3, PRES, PRES)

    return (jmap, jsynth), (tmap, tsynth)


@pytest.mark.parametrize("space,sampling,crop", [("w", "end", False), ("z", "full", True)])
def test_ppl_matches_jax_on_its_draws(space, sampling, crop):
    """The port's distances on the JAX package's draws (replayed key by key)
    and its tail rejection give JAX's PPL within 1e-5; float64 on both sides,
    since each distance is a difference over ε²."""
    (jmap, jsynth), (tmap, tsynth) = _ppl_nets()
    n, batch, eps = 40, 16, 1e-4
    with jax.enable_x64(True):
        want = jmetrics.compute_ppl(jsynth, jmap, Z, num_samples=n, epsilon=eps, space=space,
                                    sampling=sampling, crop=crop, batch=batch, seed=3)
        rng, dists = jax.random.PRNGKey(3), []
        for lo in range(0, n, batch):
            b = min(batch, n - lo)
            rng, k1, k2, k3, _ = jax.random.split(rng, 5)
            z0, z1 = (torch.from_numpy(np.asarray(jax.random.normal(k, (b, Z)))) for k in (k1, k2))
            t = (torch.from_numpy(np.asarray(jax.random.uniform(k3, (b, 1))))
                 if sampling == "full" else torch.zeros((b, 1), dtype=torch.float64))
            dists.append(tmetrics.ppl_distances(tsynth, tmap, z0, z1, t, eps, space, crop))
    got = tmetrics.ppl_from_distances(torch.cat(dists).numpy())
    assert want["ppl_distance"] == "pixel" and abs(got - want["ppl"]) <= 1e-5 * abs(want["ppl"])
    z0, z1 = np.random.RandomState(9).randn(2, 4, Z)
    t = np.random.RandomState(10).rand(4, 1)
    np.testing.assert_allclose(
        tmetrics.slerp(torch.from_numpy(z0), torch.from_numpy(z1), torch.from_numpy(t)).numpy(),
        np.asarray(jmetrics.slerp(jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(t))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("res,ch,crop", [(512, 3, True), (512, 1, False), (64, 3, True)])
def test_ppl_prepare_images_matches_jax(res, ch, crop):
    """The centre crop, the downsample by the full resolution over 256 and
    grayscale to RGB; NCHW in the port."""
    x = np.random.RandomState(11).uniform(-1, 1, (2, res, res, ch)).astype(np.float32)
    want = np.asarray(jmetrics._ppl_prepare_images(jnp.asarray(x), crop))
    got = tmetrics._ppl_prepare_images(torch.from_numpy(x).permute(0, 3, 1, 2), crop)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)


def test_registry_and_lpips():
    assert tmetrics.list_metrics() == jmetrics.list_metrics()
    assert all(tmetrics._METRICS[k].max_real == jmetrics._METRICS[k].max_real
               for k in jmetrics.list_metrics())
    # LPIPS (models/vgg.py) with random weights from a seed: feature
    # vectors whose squared difference is the distance.
    feature_fn = tmetrics.make_lpips_feature_fn(device="cpu")
    x = torch.from_numpy(np.random.RandomState(12).uniform(-1, 1, (2, 3, 32, 32))
                         .astype(np.float32))
    f = feature_fn(x)
    assert f.shape[0] == 2 and torch.isfinite(f).all() and float((f[0] - f[1]).square().sum()) > 0
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.calc_metric("fid1k")


# --- the pipeline -------------------------------------------------------------------

N_IMG, BATCH, NCLS = 16, 8, 5
SPC = np.array([150, 120, 60, 10, 5])   # classes 0-1 'many', 2 'low', 3-4 'few'


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """Inception weights as a torchvision ``.pth``, loaded by both packages'
    evaluators (JAX's jitted once, at batch 8 of 32²): the port's random
    init from a seed (He-normal convs, batch norm the identity), under which
    the pool features follow the input, its ``fc`` scaled up.  (Under the golden test's synthetic
    weights, whose batch-norm shifts dominate 94 small convs, they vary
    across images by about f32 rounding only.)"""
    path = tmp_path_factory.mktemp("inception") / "inception_v3.pth"
    net = tinception.InceptionV3(device="cpu", generator=torch.Generator().manual_seed(17))
    sd = net.state_dict()
    sd["fc.weight"] *= 30.0   # logits of a few units: class probabilities far from uniform
    torch.save(sd, path)
    jev = jpipe.InceptionEvaluator(str(path))
    tev = tpipe.InceptionEvaluator(str(path), device="cpu")
    assert jev.pretrained and tev.pretrained
    return str(path), jev, tev


# evaluate_generator's comparison runs on the pool's first D_POOL features.
D_POOL = 256


class Replay:
    """The port evaluator's features of each batch, the pool cut to its
    first ``D_POOL``, computed on the first pass and replayed on the next,
    with the branch's device-output flag."""

    def __init__(self, ev):
        self.ev, self.device, self.seen, self.i = ev, ev.device, [], 0

    def __call__(self, images, device_output=False):
        if self.i == len(self.seen):
            pool, logits = self.ev(images, device_output=True)
            self.seen.append((images, (pool[:, :D_POOL], logits)))
        imgs, (pool, logits) = self.seen[self.i]
        assert torch.equal(torch.as_tensor(images), torch.as_tensor(imgs))
        self.i += 1
        return (pool, logits) if device_output else (pool.numpy(), logits.numpy())


class JaxFirstFeatures:
    """The JAX evaluator, the pool cut to its first ``D_POOL`` features, in
    the JAX package's device branch (its host branch holds 2048-wide
    moments)."""

    supports_device_output = True

    def __init__(self, ev):
        self.ev = ev

    def __call__(self, images, device_output=False):
        pool, logits = self.ev(images, device_output=True)
        return pool[:, :D_POOL], logits


def _fid_low_rank(mu1, sigma1, mu2, sigma2):
    """FID in float64 with the exact trace for a ``sigma1`` of rank under 40
    (fewer than 41 samples): on an orthonormal basis Q of its range,
    sigma1 = Q·B·Qᵀ and tr √(sigma1·sigma2) = Σᵢ √λᵢ(√B·Qᵀ·sigma2·Q·√B), a
    40-dimensional symmetric eigenproblem."""
    q, _ = np.linalg.qr(sigma1 @ np.random.RandomState(0).randn(len(sigma1), 40))
    b = q.T @ sigma1 @ q
    assert np.linalg.norm(sigma1 - q @ b @ q.T) <= 1e-9 * np.linalg.norm(sigma1)
    w, v = np.linalg.eigh((b + b.T) / 2)
    r = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    lam = np.linalg.eigvalsh(r @ (q.T @ sigma2 @ q) @ r)
    d = mu1 - mu2
    return float(d @ d + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.sqrt(np.clip(lam, 0, None)).sum())


def _exact_tail(pool, logits, ref_mu, ref_sigma, num_splits=10):
    """``fid_is_device`` with ``_fid_low_rank``'s float64 trace in place of
    the 2048-wide Newton-Schulz square root (held to JAX's at dimensions
    64-256 above, and at 2048 on the card)."""
    p = pool.double().numpy()
    fid = _fid_low_rank(p.mean(0), np.cov(p, rowvar=False), ref_mu, ref_sigma)
    return (torch.tensor(fid),) + tfid.inception_score_device(logits, num_splits)


def test_evaluate_generator_matches_jax_in_both_branches(evaluators):
    """FID and IS within 1e-3 relative of the JAX package's, the PRDC equal,
    in the port's device and host branches, with stratified FID (the 'many'
    stratum).  The same 16 images through Inception on
    each side, the metrics on the pool's first ``D_POOL`` features; the JAX
    side in its device branch (one ``fid_is_device`` tail), its stratified
    FID on the host.  At that width 16 images give a rank-deficient
    covariance: the eigenvalue path on both sides."""
    _, jev, tev = evaluators
    rng = np.random.RandomState(12)
    imgs = np.tanh(rng.randn(N_IMG, RES, RES, 3)).astype(np.float32)
    labels = rng.randint(0, NCLS, N_IMG)
    ref_mu, ref_sigma = _ref_moments(D_POOL, 13)
    strat = {"many": _ref_moments(D_POOL, 14)}
    real = _features(N_IMG, D_POOL, 15)

    def sampler(layout):
        pos = [0]

        def sample_fn(b):
            lo, pos[0] = pos[0], pos[0] + b
            x = imgs[lo:lo + b]
            return (x if layout == "nhwc" else torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    labels[lo:lo + b])
        return sample_fn

    kw = dict(num_images=N_IMG, batch=BATCH, num_splits=4, prdc_ref_features=real,
              prdc_nearest_k=3, samples_per_class=SPC)
    want = jpipe.evaluate_generator(sampler("nhwc"), JaxFirstFeatures(jev), ref_mu, ref_sigma,
                                    stratified=strat, **kw)
    replay = Replay(tev)
    for on_device in (True, False):
        replay.supports_device_output, replay.i = on_device, 0
        got = tpipe.evaluate_generator(sampler("nchw"), replay, ref_mu, ref_sigma,
                                       stratified=strat, **kw)
        assert set(got) == set(want)
        for k in ("FID", "IS_mean", "IS_std", "FID_many"):
            assert _rel(got[k], want[k]) < 1e-3, (on_device, k, got[k], want[k])
        for k in ("precision", "recall", "density", "coverage"):
            assert got[k] == want[k], (on_device, k)
    assert np.isfinite(want["FID"]) and want["FID"] > 0 and len(replay.seen) == N_IMG // BATCH


def test_dataset_moments_and_feature_cache_match_jax(evaluators, files, tmp_path):  # noqa: F811
    """Real images through ``HDF5Dataset._norm`` (the JAX formula, bit for
    bit): moments and IS against JAX's, strata included; the feature cache
    written once, read back, and keyed by the compute dtype and package."""
    path, jev, tev = evaluators
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    args = dict(root=str(files / names["xy"]), root_feats=str(files / names["feats"]),
                root_nns=str(files / names["nns"]), k_nn=K)
    jds, tds = jdata.HDF5Dataset(**args), tdata.HDF5Dataset(**args)
    raw = tds._get_images(np.arange(4))
    np.testing.assert_array_equal(tds._norm(raw), np.transpose(jds._norm(jds._get_images(
        np.arange(4))), (0, 3, 1, 2)))
    spc = np.array([150, 50, 10, 150, 50])
    want = jpipe.compute_dataset_moments(jds, jev, batch=BATCH, max_items=BATCH,
                                         samples_per_class=spc)
    got = tpipe.compute_dataset_moments(tds, tev, batch=BATCH, max_items=BATCH,
                                        samples_per_class=spc)
    assert set(got) == set(want) == {"", "many", "low", "few"}
    for k, (mu, sigma, is_) in want.items():
        np.testing.assert_allclose(got[k][0], mu, rtol=2e-3, atol=2e-4 * np.abs(mu).max())
        np.testing.assert_allclose(got[k][1], sigma, rtol=2e-3, atol=1e-3 * np.abs(sigma).max())
        np.testing.assert_allclose(got[k][2], is_, rtol=1e-3)
    cache = tmp_path / "cache"
    pool = tpipe.cached_real_features(tds, tev, str(cache), BATCH, batch=BATCH)
    assert pool.shape == (BATCH, 2048) and len(os.listdir(cache)) == 1
    np.testing.assert_array_equal(tpipe.cached_real_features(tds, tev, str(cache), BATCH), pool)
    bf16 = tpipe.InceptionEvaluator(path, deploy_bf16=True, device="cpu")
    tpipe.cached_real_features(tds, bf16, str(cache), 2, batch=2)
    assert len(os.listdir(cache)) == 2
    with pytest.raises(NotImplementedError, match="A.9"):
        tpipe.InceptionEvaluator(device="cpu", mesh=object())
    assert tpipe.moments_filename(64, "imagenet_lt", True, "val") == jpipe.moments_filename(
        64, "imagenet_lt", True, "val") == "I64longtail_val_inception_moments.npz"


def test_fused_feature_fn_pads_the_tail_as_the_sampler(evaluators):
    """G then Inception in one call, the tail batch padded: the features of
    direct calls on the sampler's images."""
    from ic_gan_tpu_torch.io.deploy import make_sampler
    from ic_gan_tpu_torch.models.biggan import BigGANConfig, Generator

    _, _, tev = evaluators
    cfg = BigGANConfig(resolution=32, G_ch=8, G_attn="0", dim_z=20, instance_sz=12)
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sampler = make_sampler(g, batch_size=4, device="cpu")
    fused = tpipe.make_fused_feature_fn(sampler, tev)
    gen = torch.Generator().manual_seed(1)
    z, feats = torch.randn(6, cfg.effective_dim_z, generator=gen), torch.randn(6, 12, generator=gen)
    pool, logits = fused(z, feats=feats)
    imgs = torch.from_numpy(sampler(z, feats=feats)).permute(0, 3, 1, 2)
    want_pool, want_logits = tev(imgs)
    assert pool.shape == (6, 2048) and logits.shape == (6, 1000)
    np.testing.assert_allclose(pool.numpy(), want_pool, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5, atol=1e-4)


# --- the CLIs ---------------------------------------------------------------------

def _data_root(files, root):  # noqa: F811
    """The toy HDF5 set and reference moments for its resolution, under
    ``root``."""
    root.mkdir(parents=True)
    for name in os.listdir(files):
        shutil.copy(files / name, root / name)
    mu, sigma = _ref_moments(2048, 16)
    np.savez(root / tpipe.moments_filename(RES), mu=mu, sigma=sigma)
    return root


def test_biggan_cli_evaluates_keeps_the_best_copy_and_logs(files, tmp_path, capsys, evaluators,  # noqa: F811
                                                          monkeypatch):
    """One epoch of two steps, then ``Trainer.test`` through
    ``make_train_eval_fn`` (8 images, the tail's trace exact): a finite FID
    and IS in the test log, the first best copy saved; without moments,
    eval is disabled."""
    monkeypatch.setattr(tpipe, "fid_is_device", _exact_tail)
    data = _data_root(files, tmp_path / "data")
    argv = _cli_config(files, tmp_path, data_root=str(data), num_epochs=1, test_every=1,
                       num_inception_images=8, eval_batch_size=4,
                       inception_weights=evaluators[0])
    tr = tcli.main(argv)
    assert "eval disabled" not in capsys.readouterr().out
    h = tr.history
    assert np.isfinite(h["best_FID"]) and h["best_FID"] > 0 and h["save_best_num"] == 1
    assert sorted(os.listdir(tmp_path / "w")) == ["cli", "cli_best0", "cli_copy0"]
    with open(tmp_path / "l" / "cli" / "cli_test_log.jsonl") as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["itr"] == 2 and rec["FID"] == h["best_FID"] and np.isfinite(rec["IS_mean"])
    os.remove(data / tpipe.moments_filename(RES))
    tr = tcli.main(_cli_config(files, tmp_path / "b", data_root=str(data), num_epochs=0))
    assert tr.eval_fn is None and "eval disabled (reference moments not found" in \
        capsys.readouterr().out


# What ``Trainer.test`` writes into the history after the epoch's snapshot.
EVAL_KEYS = ("best_IS", "best_FID", "save_best_num", "epochs_no_improvement")


def test_biggan_cli_with_eval_resumes_bit_for_bit(files, tmp_path, evaluators, monkeypatch):  # noqa: F811
    """With reference moments in place the CLI evaluates after every epoch,
    and the eval comes after the snapshot.  Two epochs straight, and one
    epoch then a resume for the second: the same state bit for bit, the
    same sampler stream and the same FID at the last eval, with the
    sampler's stream running on across epochs (``deterministic_run`` off).
    The eval draws its conditioning from a stream of its own: from the
    sampler's, it would leave that stream past where the snapshot recorded
    it, and the resumed run would draw other batches."""
    monkeypatch.setattr(tpipe, "fid_is_device", _exact_tail)
    data = _data_root(files, tmp_path / "data")

    def run(root, **kw):
        return tcli.main(_cli_config(files, tmp_path / root, data_root=str(data), test_every=1,
                                     num_inception_images=2, eval_batch_size=2,
                                     inception_weights=evaluators[0], **kw))

    straight = run("a")
    first = run("b", num_epochs=1)
    assert first.history["itr"] == 2 and np.isfinite(first.history["best_FID"])
    resumed = run("b", resume=True)
    assert resumed.history["itr"] == straight.history["itr"] == 4
    assert {k: v for k, v in straight.history.items() if k not in EVAL_KEYS} == {
        k: v for k, v in resumed.history.items() if k not in EVAL_KEYS}
    assert straight.dataset.rng.bit_generator.state == resumed.dataset.rng.bit_generator.state
    a, b = _state_tensors(straight.state), _state_tensors(resumed.state)
    assert set(a) == set(b) and all(torch.equal(v, b[k]) for k, v in a.items())
    logs = [[json.loads(line) for line in open(tmp_path / r / "l" / "cli" / "cli_test_log.jsonl")]
            for r in ("a", "b")]
    assert [r["itr"] for r in logs[0]] == [r["itr"] for r in logs[1]] == [2, 4]
    assert logs[0][1]["FID"] == logs[1][1]["FID"] and np.isfinite(logs[0][1]["FID"])


def test_stylegan2_cli_builds_its_snapshot_eval(files, tmp_path, capsys, monkeypatch, evaluators):  # noqa: F811
    """The CLI's ``eval_fn`` on a stand-in trainer: ``evaluate_generator``
    (held above; recorded here) gets the moments file's reference, the
    config's image count and batch, the evaluator of its weights, and EMA
    samples drawn with seeds 123 + the batch's count, their conditioning
    from a stream other than the sampler's; without moments, eval is
    disabled."""
    from ic_gan_tpu_torch.train import stylegan2_trainer

    class Trainer:
        def __init__(self, *args, eval_fn=None, device=None):
            self.eval_fn, self.device, self.seeds = eval_fn, torch.device(device), []
            self.dataset, self.streams = args[3], []

        def run(self, max_steps=None):
            pass

        def sample_fn(self, n, generator):
            self.seeds.append(generator.initial_seed())
            self.streams.append(self.dataset.rng)
            return torch.zeros((n, 3, RES, RES)), None, None

    calls = []

    def evaluate_generator(sample_fn, evaluator, ref_mu, ref_sigma, num_images, batch):
        imgs = [sample_fn(batch) for _ in range(2)]
        calls.append((evaluator, ref_mu, ref_sigma, num_images, batch, imgs))
        return {"FID": 1.0}

    monkeypatch.setattr(stylegan2_trainer, "SG2Trainer", Trainer)
    monkeypatch.setattr(tpipe, "evaluate_generator", evaluate_generator)
    data = _data_root(files, tmp_path / "data")
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    argv = ["--set", f"data_root={data}", f"data={data / names['xy']}",
            f"root_feats={data / names['feats']}", f"root_nns={data / names['nns']}",
            f"resolution={RES}", f"k_nn={K}", "num_inception_images=6", "eval_batch_size=4",
            f"inception_weights={evaluators[0]}", "--device", "cpu"]
    tr = tsg2cli.main(argv)
    live = tr.dataset.rng
    assert tr.eval_fn(tr) == {"FID": 1.0} and tr.seeds == [124, 125]
    # The conditioning from the eval's own stream, the sampler's back after it.
    assert tr.dataset.rng is live and all(r is not live for r in tr.streams)
    ev, mu, sigma, n, b, imgs = calls[0]
    assert (n, b, ev.pretrained, ev.device, ev.net.dtype) == (6, 4, True, tr.device, torch.float32)
    np.testing.assert_array_equal(mu, _ref_moments(2048, 16)[0])
    np.testing.assert_array_equal(sigma, _ref_moments(2048, 16)[1])
    assert [tuple(x.shape) for x, lab in imgs] == [(4, 3, RES, RES)] * 2 and imgs[0][1] is None
    tr.eval_fn(tr)
    assert tr.seeds == [124, 125, 124, 125]   # the count starts anew at each eval
    assert "eval disabled" not in capsys.readouterr().out
    os.remove(data / tpipe.moments_filename(RES))
    assert tsg2cli.main(argv).eval_fn is None
    assert "eval disabled (reference moments not found" in capsys.readouterr().out


def test_entry_points_run_on_cuda_unless_told(files, tmp_path):  # noqa: F811
    """Without a device argument every entry point takes CUDA, and refuses
    where it is absent: the evaluator, the trainers' eval, the metrics and
    both CLIs with reference moments in place."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    data = _data_root(files, tmp_path / "data")
    mu, sigma = _ref_moments(8, 18)
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    for call in (tpipe.InceptionEvaluator,
                 lambda: tpipe.make_train_eval_fn({"data_root": str(data), "resolution": RES}),
                 lambda: tfid.frechet_distance(mu, sigma, mu, sigma),
                 lambda: tprdc.compute_prdc(sigma, sigma),
                 lambda: tmetrics.compute_ppl(None, None, 4),
                 lambda: tcli.main(_cli_config(files, tmp_path, data_root=str(data))[:2]),
                 lambda: tsg2cli.main(["--set", f"data_root={data}", f"resolution={RES}",
                                       f"data={data / names['xy']}", f"k_nn={K}"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
