"""The port's remaining CLIs (``cli/visualize.py``, ``cli/projector.py``,
``cli/plot_logs.py``) against the JAX package's, on the CPU.

- Sheets: ``sample_sheet``, ``interp_sheet`` in both modes (``fix_z``,
  ``fix_feats``) with class rows, and ``style_mixing_grid`` against JAX's
  on the same toy weights (BigGAN res 32 ch 8 with classes and instances;
  StyleGAN2 res 32, f32).  The sheets draw z and instance indices from
  their own streams (a ``torch.Generator`` in the port, ``jax.random`` in
  JAX), so both sides are fed the same numbers: each package's draw is
  replaced by one numpy stream seeded alike (as phase 8 of
  ``chip_smoke.py`` feeds DiffAugment's draws).  Images at 1e-4.
- Each CLI ``main`` end to end on the CPU: BigGAN from an upstream ``.pth``
  bundle (sample sheet, both interpolation sheets, random sheet) and
  StyleGAN2 from a network pickle (style mixing, random), every PNG equal
  to the sheet functions called directly on the loaded sampler.
- The projector: its learning-rate and noise schedules against the
  schedule JAX's ``project`` hands its step; two steps of ``project`` (the
  first moves nothing: its ramp is 0) from the same z and w noise against
  JAX's, the losses and w at 1e-4; ``main`` end to end with the default
  perceptual features (InceptionV3's pool).
- ``plot_logs``' numpy readers against JAX's on the trainers' log formats;
  ``stylegan2_series``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.nn.utils import skip_init

import jax.numpy as jnp

from ic_gan_tpu.cli import plot_logs as jplot
from ic_gan_tpu.cli import projector as jproj
from ic_gan_tpu.cli import visualize as jvis
from ic_gan_tpu.io import deploy as jdeploy
from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu_torch.cli import plot_logs as tplot
from ic_gan_tpu_torch.cli import projector as tproj
from ic_gan_tpu_torch.cli import visualize as tvis
from ic_gan_tpu_torch.cli.config import split_config
from ic_gan_tpu_torch.cli.inference import load_model_inference
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.io.convert import stylegan2_state_dict_from_jax
from ic_gan_tpu_torch.io.deploy import make_sampler
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from test_torch_port_biggan_deep import _perturb, jax_variables
from test_torch_port_classcond import _one_torch_thread, cheap_jit, in_background  # noqa: F401
from test_torch_port_sg2 import BASE as SG2_BASE
from test_torch_port_sg2 import _numpy_variables
from test_torch_port_sg2_import import tf_pickle  # noqa: F401

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

ATOL = 1e-4
# A class- and instance-conditioned toy BigGAN, as a flat config.
BIGGAN = dict(resolution=32, G_ch=8, D_ch=8, G_attn="16", D_attn="16", hier=True,
              instance_cond=True, class_cond=True, n_classes=10, shared_dim=16,
              G_shared_feat=True, shared_dim_feat=16, dim_z=20)


class _Draws:
    """One numpy stream standing in for a package's draws: normals and
    integers of the shapes asked for, in the order asked."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def normal(self, shape):
        return self.rng.randn(*shape).astype(np.float32)

    def randint(self, shape, high):
        return self.rng.randint(0, high, shape)


def _feed_draws(monkeypatch, seed):
    """Both packages' sheet draws from two numpy streams seeded alike."""
    jd, td = _Draws(seed), _Draws(seed)
    monkeypatch.setattr(jvis.jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(jd.normal(shape)))
    monkeypatch.setattr(jvis.jax.random, "randint",
                        lambda key, shape, minval, maxval, *a, **k:
                        jnp.asarray(jd.randint(shape, maxval)))
    monkeypatch.setattr(tvis, "_randn", lambda shape, generator: torch.from_numpy(
        td.normal(shape)))
    monkeypatch.setattr(tvis, "_randint", lambda shape, high, generator: torch.from_numpy(
        td.randint(shape, high)))


@pytest.fixture(scope="module")
def biggan():
    """The toy G in the port (folded, behind ``make_sampler``) and as JAX
    variables with a cheap-compiled apply."""
    from ic_gan_tpu.cli.config import split_config as jsplit
    from ic_gan_tpu.models import biggan as jbiggan

    cfg = split_config(BIGGAN)[0]
    g = _perturb(tbiggan.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                 0)
    state = {k: v.clone() for k, v in g.state_dict().items()}     # before the fold
    jcfg = jsplit(BIGGAN)[0]
    jvars = jdeploy.fold_spectral_norm(jax_variables(state, convert.generator_key_map(cfg)))
    jg = jbiggan.Generator(jcfg)
    apply = cheap_jit(lambda v, z, y, f: jg.apply(v, z, y, f, train=False))
    bank = np.random.RandomState(1).randn(6, cfg.instance_sz).astype(np.float32)

    def japply(z, y, f):
        return apply(jvars, jnp.asarray(z), jnp.asarray(y, jnp.int32), jnp.asarray(f))

    return dict(cfg=cfg, sampler=make_sampler(g, batch_size=5, device="cpu"), japply=japply,
                bank=bank, labels=np.arange(6) % 10, state=state)


def test_sheets_match_jax(biggan, monkeypatch):
    """A sample sheet (three stored instances with their labels, 4 per row)
    and interpolation sheets (z and features, z alone, features alone; class
    rows) on the same draws: images at 1e-4."""
    b = biggan
    conds = [(b["labels"][i], b["bank"][i]) for i in range(3)]
    interp_kw = dict(num_midpoints=2, num_rows=2, feats_bank=b["bank"], labels_bank=b["labels"],
                     z_var=0.5, seed=3)
    modes = [(False, False), (False, True), (True, False)]

    def jax_side():
        out = [jvis.sample_sheet(b["japply"], b["cfg"].effective_dim_z, conds, 4, seed=1)]
        for fix_z, fix_feats in modes:
            out.append(jvis.interp_sheet(b["japply"], b["cfg"].effective_dim_z, fix_z=fix_z,
                                         fix_feats=fix_feats, **interp_kw))
        return out

    _feed_draws(monkeypatch, 7)
    want = in_background(jax_side)          # its own stream, while the port's side runs
    got = [tvis.sample_sheet(b["sampler"], b["cfg"].effective_dim_z, conds, 4, seed=1)]
    for fix_z, fix_feats in modes:
        got.append(tvis.interp_sheet(b["sampler"], b["cfg"].effective_dim_z, fix_z=fix_z,
                                     fix_feats=fix_feats, **interp_kw))
    assert [g_.shape for g_ in got] == [(12, 32, 32, 3)] + [(8, 32, 32, 3)] * 3
    for g_, w in zip(got, want.result()):
        assert w.std() > 1e-2
        np.testing.assert_allclose(g_, w, atol=ATOL, rtol=0)
    # fix_z holds z along a row, fix_feats the features: row 0's ends differ
    # in the features only, or in z only.
    assert not np.allclose(got[2][0], got[2][3]) and not np.allclose(got[3][0], got[3][3])


@pytest.fixture(scope="module")
def sg2():
    """The toy StyleGAN2 G (f32, IC-GAN features) in both packages."""
    jcfg = jsg2.StyleGAN2Config(**SG2_BASE)
    rng = np.random.RandomState(0)
    jg = jsg2.Generator(jcfg)
    z = jnp.zeros((2, jcfg.z_dim))
    h = jnp.zeros((2, jcfg.h_dim))
    jvars = _numpy_variables(jg, rng, z, None, h)
    g = skip_init(tsg2.Generator, tsg2.StyleGAN2Config(**SG2_BASE))
    g.load_state_dict(stylegan2_state_dict_from_jax(jvars))
    return dict(jg=jg, jvars=jvars, g=g.eval(), h=rng.randn(jcfg.h_dim).astype(np.float32))


def test_style_mixing_grid_matches_jax(sg2, monkeypatch):
    """Row seeds 85, 100, 75, column seeds 55 and 100, styles 0-3, ψ 0.7
    with instance features: the mixed ws and the images at 1e-4."""
    jg, jv, g = sg2["jg"], sg2["jvars"], sg2["g"]
    jmap = cheap_jit(lambda v, z, f: jg.apply(v, z, None, f, method=jg.map_ws,
                                              truncation_psi=0.7))
    jsyn = cheap_jit(lambda v, ws: jg.apply(v, ws, method=jg.synthesize, noise_mode="const"))
    kw = dict(row_seeds=[85, 100, 75], col_seeds=[55, 100], col_styles=[0, 1, 2, 3],
              cond_feats=sg2["h"], truncation_psi=0.7)
    _feed_draws(monkeypatch, 11)
    want = jvis.style_mixing_grid(lambda z, f: jmap(jv, z, f), lambda ws: jsyn(jv, ws),
                                  SG2_BASE["z_dim"], **kw)

    def map_ws(z, f):
        with torch.no_grad():
            return g.map_ws(z, None, f, truncation_psi=0.7)

    def synthesize(ws):
        with torch.no_grad():
            return g.synthesize(ws, noise_mode="const").permute(0, 2, 3, 1)

    got = tvis.style_mixing_grid(map_ws, synthesize, SG2_BASE["z_dim"], **kw)
    assert got.shape == want.shape == (6, 32, 32, 3) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()), rtol=0)
    assert tvis._parse_num_list("85,100-102, 7", None) == [85, 100, 101, 102, 7]
    assert tvis._parse_num_list(None, "0-6") == jvis._parse_num_list(None, "0-6")


def _png(path):
    return np.asarray(Image.open(path))


def _same_png(path, images, tmp_path, nrow):
    from ic_gan_tpu_torch.cli.inference import save_image_grid

    save_image_grid(images, str(tmp_path / "direct.png"), nrow=nrow)
    np.testing.assert_array_equal(_png(path), _png(tmp_path / "direct.png"))


def test_visualize_cli_biggan_end_to_end(biggan, tmp_path):
    """``main`` with the flags of ``sample.py`` on an upstream ``.pth``
    bundle and a stored-instances file: every sheet equal to the sheet
    functions on the loaded sampler, under the numbered folder."""
    bundle = tmp_path / "bundle"
    os.makedirs(bundle)
    torch.save({k: v for k, v in biggan["state"].items() if not k.endswith("accum_counter")},
               bundle / "G_ema.pth")
    torch.save({"config": BIGGAN}, bundle / "state_dict.pth")
    np.save(tmp_path / "feats.npy", {"instance_features": biggan["bank"],
                                     "labels": biggan["labels"]})
    flat = dict(BIGGAN, pth_dir=str(bundle), stored_features=str(tmp_path / "feats.npy"),
                sample_sheets=True, sample_interps=True, sample_random=True, num_imgs_gen=3,
                num_conditionings_gen=2, num_midpoints=1, num_rows=2, num_samples=5,
                sample_sheet_folder_num=2, out_dir=str(tmp_path / "out"), batch_size=4, seed=5)
    written = tvis.main(["--set"] + [f"{k}={json.dumps(v)}" for k, v in flat.items()]
                        + ["--device", "cpu"])
    out = tmp_path / "out" / "2"
    assert written == [str(out / n) for n in ("sample_sheet.png", "interp_zfeats.png",
                                              "interp_z.png", "interp_feats.png", "random.png")]
    sampler, cfg = load_model_inference(flat, device="cpu")
    dim_z, bank, labels = cfg.effective_dim_z, biggan["bank"], biggan["labels"]
    _same_png(written[0], tvis.sample_sheet(sampler, dim_z, [(labels[i], bank[i])
                                                             for i in range(2)], 3, seed=5),
              tmp_path, 3)
    for path, fix_z, fix_feats in zip(written[1:4], (False, False, True), (False, True, False)):
        _same_png(path, tvis.interp_sheet(sampler, dim_z, 1, 2, fix_z, fix_feats, bank, labels,
                                          seed=5), tmp_path, 3)
    idx = np.random.RandomState(5).randint(0, 6, 5)
    z = torch.randn((5, dim_z), generator=torch.Generator().manual_seed(5))
    _same_png(written[4], sampler(z, labels[idx], bank[idx]), tmp_path, 8)


def test_visualize_cli_stylegan2_end_to_end(tf_pickle, tmp_path):  # noqa: F811
    """``mode=style_mixing`` (upstream's seed syntax) and ``mode=random`` on
    a network pickle: each PNG equal to the functions on the loaded G."""
    base = dict(backbone="stylegan2", network_pkl=tf_pickle, out_dir=str(tmp_path / "o"),
                truncation_psi=0.8, batch_size=4)
    mix = tvis.main(["--set"] + [f"{k}={json.dumps(v)}" for k, v in dict(
        base, mode="style_mixing", row_seeds="85,100", col_seeds="55-57",
        col_styles="0-2").items()] + ["--device", "cpu"])
    rand = tvis.main(["--set"] + [f"{k}={json.dumps(v)}" for k, v in dict(
        base, mode="random", num_samples=6).items()] + ["--device", "cpu"])
    sampler, cfg = load_model_inference(base, device="cpu")
    g = sampler.module
    with torch.no_grad():
        want = tvis.style_mixing_grid(
            lambda z, f: g.map_ws(z, None, f, truncation_psi=0.8),
            lambda ws: g.synthesize(ws, noise_mode="const").permute(0, 2, 3, 1),
            cfg.z_dim, [85, 100], [55, 56, 57], [0, 1, 2])
    assert _png(mix[0]).shape == (2 * 16, 3 * 16, 3)
    _same_png(mix[0], want, tmp_path, 3)
    z = torch.randn((6, cfg.z_dim), generator=torch.Generator().manual_seed(0))
    _same_png(rand[0], sampler(z), tmp_path, 8)


# --- the projector ----------------------------------------------------------------

def test_projector_schedule_matches_jax(monkeypatch):
    """The (lr ramp, w noise) JAX's ``project`` hands its step at each of 40
    steps equal ``schedule``'s, w_std 1 (the stand-in mapping's ws are ±1)."""
    recorded = []

    class Gen:
        cfg = type("cfg", (), {"z_dim": 3})

        @staticmethod
        def apply(variables, z, c, h, method=None):
            return jnp.where(jnp.arange(z.shape[0])[:, None, None] % 2 == 0, 1.0, -1.0) \
                * jnp.ones((z.shape[0], 4, 5))

        map_ws = synthesize = None

    def fake_jit(fn):
        def step(w, opt_state, step_rng, lr_scale, w_noise_scale):
            recorded.append((float(lr_scale), float(w_noise_scale)))
            return w, opt_state, jnp.zeros(())
        return step

    monkeypatch.setattr(jproj.jax, "jit", fake_jit)
    jproj.project(Gen(), {}, jnp.zeros((4, 4, 3)), num_steps=40, w_avg_samples=8,
                  feature_fn=lambda x: jnp.sum(x))
    assert len(recorded) == 40 and recorded[0][0] == 0.0
    for it, (lr, noise) in enumerate(recorded):
        np.testing.assert_allclose(tproj.schedule(it, 40), (lr, noise), rtol=1e-6, atol=1e-7)


def test_projector_steps_match_jax(sg2, monkeypatch):
    """Two steps of ``project`` from the same w statistics (the same z through
    ``map_ws``), target, features and w noise in both packages: the losses
    and the projected w at 1e-4."""
    jg, jv, g = sg2["jg"], sg2["jvars"], sg2["g"]
    rng = np.random.RandomState(4)
    proj = rng.randn(32 * 32 * 3, 6).astype(np.float32) / 50
    target = np.tanh(rng.randn(32, 32, 3)).astype(np.float32)
    draws = {(24, SG2_BASE["z_dim"]): rng.randn(24, SG2_BASE["z_dim"]).astype(np.float32),
             (1, SG2_BASE["w_dim"]): rng.randn(1, SG2_BASE["w_dim"]).astype(np.float32)}
    kw = dict(cond_feats=sg2["h"], num_steps=2, w_avg_samples=24, initial_learning_rate=0.2,
              initial_noise_factor=0.5)
    monkeypatch.setattr(jproj.jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(draws[tuple(shape)]))
    want = in_background(jproj.project, jg, jv, jnp.asarray(target),
                         feature_fn=lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(proj),
                         **{**kw, "cond_feats": jnp.asarray(sg2["h"])})
    monkeypatch.setattr(tproj, "_randn", lambda shape, generator, device: torch.from_numpy(
        draws[tuple(shape)]))
    got_w, got_hist = tproj.project(
        g, target, feature_fn=lambda x: x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        @ torch.from_numpy(proj), **kw)
    want_w, want_hist = want.result()
    assert got_w.shape == want_w.shape == (g.synthesis.num_ws, SG2_BASE["w_dim"])
    np.testing.assert_allclose(got_hist, want_hist, atol=ATOL * max(1.0, max(want_hist)),
                               rtol=0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL, rtol=0)
    w_avg = g.map_ws(torch.from_numpy(draws[(24, SG2_BASE["z_dim"])]), None,
                     torch.from_numpy(sg2["h"])[None].expand(24, -1))[:, 0].mean(0)
    assert not torch.allclose(got_w[0], w_avg)            # the second step moved w


def test_projector_cli_end_to_end(tf_pickle, tmp_path):  # noqa: F811
    """``main`` on a network pickle and a non-square target image, with the
    default perceptual features: the three outputs, a w of the model's
    shape, finite losses, a projection image that is the synthesis of w."""
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (20, 24, 3), np.uint8)).save(
        tmp_path / "target.png")
    history = tproj.main(["--set", f"network_pkl={tf_pickle}", f"target={tmp_path}/target.png",
                          f"out_dir={tmp_path}/proj", "num_steps=2", "w_avg_samples=16",
                          "--device", "cpu"])
    assert len(history) == 2 and np.all(np.isfinite(history))
    w = np.load(tmp_path / "proj" / "projected_w.npz")["w"]
    g = load_model_inference(dict(backbone="stylegan2", network_pkl=tf_pickle),
                             device="cpu")[0].module
    assert w.shape == (1, g.synthesis.num_ws, g.cfg.w_dim)
    assert _png(tmp_path / "proj" / "target.png").shape == (16, 16, 3)
    with torch.no_grad():
        img = g.synthesize(torch.from_numpy(w), noise_mode="const").permute(0, 2, 3, 1)
    _same_png(tmp_path / "proj" / "proj.png", img.numpy(), tmp_path, 1)


# --- plot_logs and the CLIs without a card ------------------------------------------

def test_plot_logs_readers_match_jax(tmp_path):
    """The readers on a BigGAN run directory in the trainer's formats (the
    train and test jsonl, a per-metric ``.log``) equal JAX's, the training
    plots list alike; ``stylegan2_series`` reads a StyleGAN2 run's tick and
    snapshot records."""
    from ic_gan_tpu_torch.utils.logging import MetricLogger, MetricsLogger

    d = tmp_path / "exp"
    os.makedirs(d)
    train = MetricsLogger(str(d / "exp_log.jsonl"))
    test = MetricsLogger(str(d / "exp_test_log.jsonl"))
    rng = np.random.RandomState(0)
    for i in range(12):
        rec = dict(itr=100 * i, G_loss=float(rng.randn()), D_loss_real=float(rng.randn()),
                   D_loss_fake=float(rng.randn()))
        if i % 4 == 0:
            rec["G_sv/blocks_0_conv1"] = 1.0 + 0.01 * i
        train.log(**rec)
        if i % 3 == 0:
            test.log(itr=100 * i, IS_mean=5.0 + i, IS_std=0.1, FID=90.0 - i)
    MetricLogger(str(d)).log(300, G_sv0=1.5)
    rows = tplot.read_jsonl(tplot.find_train_jsonl(str(d)))
    assert rows == jplot.read_jsonl(jplot.find_train_jsonl(str(d)))
    for key in ("G_loss", "G_sv/blocks_0_conv1"):
        for a, b in zip(tplot.series_from_jsonl(rows, key), jplot.series_from_jsonl(rows, key)):
            np.testing.assert_array_equal(a, b)
    for k, v in jplot.inception_series(str(d)).items():
        np.testing.assert_array_equal(tplot.inception_series(str(d))[k], v)
    for a, b in zip(tplot.read_metric_log(str(d / "G_sv0.log")),
                    jplot.read_metric_log(str(d / "G_sv0.log"))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tplot.smooth(np.arange(9.0) ** 2, 5),
                                  jplot.smooth(np.arange(9.0) ** 2, 5))
    argv = ["--set", f"logs_dir={d}", f"out_dir={tmp_path / 'plots'}"]
    names = [os.path.basename(p) for p in tplot.main(argv)]
    assert names == [os.path.basename(p) for p in jplot.main(argv)] == [
        "losses.png", "G_sv.png"]
    run = tmp_path / "sg2"
    os.makedirs(run)
    for kimg in (0.032, 0.064):
        MetricsLogger(str(run / "stats.jsonl")).log(
            {"kimg": kimg, "sec_per_kimg": 20.0, "augment_p": 0.1, "G_loss": 1.0})
    MetricsLogger(str(run / "metric-fid.jsonl")).log(
        {"results": {"FID": 80.0, "IS_mean": 2.0}, "snapshot_kimg": 0.064})
    series = tplot.stylegan2_series(str(run))
    np.testing.assert_array_equal(series["kimg"], [0.032, 0.064])
    assert series["FID"].tolist() == [80.0] and series["snapshot_kimg"].tolist() == [0.064]
    assert sorted(series) == ["FID", "G_loss", "IS_mean", "augment_p", "kimg",
                              "sec_per_kimg", "snapshot_kimg"]


def test_visualize_and_projector_raise_without_a_card(tf_pickle, tmp_path):  # noqa: F811
    """Both CLIs default to CUDA and raise without a card."""
    for call in (lambda: tvis.main(["--set", "backbone=stylegan2", f"network_pkl={tf_pickle}",
                                    "mode=random"]),
                 lambda: tproj.main(["--set", f"network_pkl={tf_pickle}", "target=x.png"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
