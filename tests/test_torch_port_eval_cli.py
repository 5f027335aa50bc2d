"""The port's eval CLIs (``cli/test.py``, ``cli/calc_metrics.py``) on the
CPU, on toy models from seeds: a native checkpoint of an IC-GAN BigGAN G
(class and instance conditioning, attention at 16²) and a StyleGAN2
network pickle (instance-conditioned).

- Each CLI's metrics equal direct calls of the already-held
  ``evaluate_generator`` / ``calc_metric`` on the same draws (the same
  conditioning stream, z generators and standing statistics), every option
  of ``cli/test.py`` on: ``accumulate_stats``, ``eval_prdc``,
  ``fused_eval``, ``sample_trunc_curves``, ``metrics_out``, ``sample_npz``.
- The output formats are the JAX package's: its CLIs, run here with their
  model and metric calls replaced by the port's results, write the same
  ``metrics_out`` dict, the same ``sample_npz`` array and the same
  ``metric-*.jsonl`` records (but the time stamp).

Inception is a small stand-in network here (a pooled projection to 2048
features and 1000 logits): the CLIs' wiring is what is under test, and
InceptionV3 itself is held to JAX's in ``test_torch_port_eval.py`` and run
by both CLIs on the card (``chip_smoke.py`` phase 17).  The FID tail takes
the exact float64 trace of its low-rank covariance (``_exact_tail``).
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import ic_gan_tpu.eval.metrics as jmetrics_mod
import ic_gan_tpu.eval.pipeline as jpipe
from ic_gan_tpu.cli import calc_metrics as jcalc
from ic_gan_tpu.cli import test as jtest
from ic_gan_tpu_torch.cli import calc_metrics as tcalc
from ic_gan_tpu_torch.cli import inference as tinf
from ic_gan_tpu_torch.cli import test as ttest
from ic_gan_tpu_torch.cli.config import split_config
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.eval import metrics as tmetrics
from ic_gan_tpu_torch.eval import pipeline as tpipe
from ic_gan_tpu_torch.io.checkpoint import save_checkpoint
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.models import vgg as tvgg
from ic_gan_tpu_torch.models.biggan_deep import model_classes
from ic_gan_tpu_torch.train.state import GANTrainState
from test_torch_port_biggan_loop import K, MODEL, RES, files  # noqa: F401
from test_torch_port_classcond import _one_torch_thread  # noqa: F401
from test_torch_port_eval import _data_root, _exact_tail

h5py = pytest.importorskip("h5py")


class _StandInNet(nn.Module):
    """NCHW images in [-1, 1] → (pool (N, 2048), logits (N, 1000)) through an
    8×8 average pool and two fixed projections from a seed."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.proj = nn.Parameter(torch.randn((192, 2048), generator=gen))
        self.fc = nn.Parameter(torch.randn((2048, 1000), generator=gen) / 4)

    def forward(self, x):
        pool = torch.tanh(F.adaptive_avg_pool2d(x.float(), 8).flatten(1) @ self.proj)
        return pool, pool @ self.fc


class StandInEvaluator(tpipe.InceptionEvaluator):
    """``InceptionEvaluator``'s surface over ``_StandInNet``."""

    def __init__(self, weights_path=None, mesh=None, deploy_bf16=False, device=None):
        self.device = torch.device(device or "cpu")
        self.net = _StandInNet().to(self.device).requires_grad_(False)
        self.pretrained = False


@pytest.fixture()
def stand_in(monkeypatch):
    monkeypatch.setattr(tpipe, "InceptionEvaluator", StandInEvaluator)
    monkeypatch.setattr(tpipe, "fid_is_device", _exact_tail)


BIGGAN = dict(MODEL, instance_cond=True, G_shared_feat=True, hier=True, G_attn="16")


def _biggan_checkpoint(root):
    """A native checkpoint of the toy G and D from a seed, named as
    ``Trainer`` names a best copy."""
    cfg, tcfg = split_config(BIGGAN)[:2]
    gen = torch.Generator().manual_seed(30)
    g_cls, d_cls = model_classes(cfg)
    g, d = g_cls(cfg, device="cpu", generator=gen), d_cls(cfg, device="cpu", generator=gen)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    save_checkpoint(str(root), "toy", state, config={"best_FID": 3.0}, suffix="best0")


def _argv(cfg, path):
    path.write_text(json.dumps(cfg))
    return ["--json_config", str(path), "--device", "cpu"]


def test_test_cli_equals_direct_calls_and_writes_jax_formats(files, tmp_path, stand_in,  # noqa: F811
                                                            monkeypatch):
    data = _data_root(files, tmp_path / "data")
    _biggan_checkpoint(tmp_path / "w")
    cfg = dict(BIGGAN, weights_root=str(tmp_path / "w"), experiment_name="toy",
               data_root=str(data), k_nn=K, seed=3, batch_size=4, num_inception_images=20,
               eval_batch_size=4, accumulate_stats=True, num_standing_accumulations=2,
               eval_prdc=True, prdc_ref_images=8, prdc_nearest_k=2,
               sample_trunc_curves="0.5_0.5_1.0", metrics_out=str(tmp_path / "m.npy"),
               sample_npz=True, sample_num_npz=6, npz_path=str(tmp_path / "s.npz"))
    got = ttest.main(_argv(cfg, tmp_path / "cfg.json"))

    # The same calls by hand, in the CLI's order.
    apply_fn, mcfg = tinf.load_model_inference(cfg, device="cpu")
    kw = split_config(cfg, inference=True)[3]
    dataset = tdata.get_dataset_hdf5(**dict(kw, class_cond=True, instance_cond=True),
                                     device="cpu")
    apply_fn = apply_fn.with_standing_stats(
        lambda n: dataset.sample_conditioning_instance_balance(n))
    sample = tinf.make_conditioned_sampler(cfg, apply_fn, mcfg, dataset, z_var=1.0)
    ev = StandInEvaluator()
    ref = np.load(data / tpipe.moments_filename(RES))
    prdc = tpipe.cached_real_features(dataset, ev, str(data / "feature_cache"), 8, batch=4)
    want = tpipe.evaluate_generator(
        ttest.nchw(sample), ev, ref["mu"], ref["sigma"], num_images=20, batch=4,
        prdc_ref_features=prdc, prdc_nearest_k=2,
        feature_fn=tinf.make_conditioned_feature_fn(sample, ev))
    curve = [dict(z_var=v, **tpipe.evaluate_generator(
        ttest.nchw(tinf.make_conditioned_sampler(cfg, apply_fn, mcfg, dataset, z_var=v)),
        ev, ref["mu"], ref["sigma"], num_images=20, batch=4)) for v in (0.5, 1.0)]
    imgs = np.concatenate([sample(b)[0].numpy() for b in (4, 2)])
    assert set(want) == {"IS_mean", "IS_std", "FID", "precision", "recall", "density",
                         "coverage"}
    for k, v in want.items():
        assert np.isfinite(v) and got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert [p["z_var"] for p in got["trunc_curves"]] == [0.5, 1.0]
    for p, q in zip(got["trunc_curves"], curve):
        for k, v in q.items():
            assert p[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert curve[0]["FID"] != curve[1]["FID"] and want["IS_mean"] > 1.1
    x = np.load(tmp_path / "s.npz")["x"]
    assert x.dtype == np.uint8 and x.shape == (6, 3, RES, RES)
    np.testing.assert_array_equal(x, np.transpose(((imgs + 1) / 2 * 255).astype(np.uint8),
                                                  (0, 3, 1, 2)))
    saved = np.load(tmp_path / "m.npy", allow_pickle=True).item()
    assert saved.keys() == got.keys()

    # The JAX CLI over the port's results writes the same files.
    def jax_evaluate(sample_fn, evaluator, mu, sigma, num_images, batch, **kw):
        return {k: v for k, v in got.items() if k != "trunc_curves"} if "feature_fn" in kw else {
            k: v for k, v in got["trunc_curves"][jax_evaluate.calls.pop(0)].items()
            if k != "z_var"}

    jax_evaluate.calls = [0, 1]
    jimgs = iter([imgs[:4], imgs[4:]])
    monkeypatch.setattr(jtest, "load_model_inference", lambda c: (
        types.SimpleNamespace(with_standing_stats=lambda f: None), types.SimpleNamespace()))
    monkeypatch.setattr(jtest, "make_conditioned_sampler",
                        lambda *a, **k: lambda b: (next(jimgs), None))
    monkeypatch.setattr(jtest, "conditioning_flags", lambda c, m: (True, True))
    monkeypatch.setattr(jpipe, "InceptionEvaluator", lambda *a, **k: None)
    monkeypatch.setattr(jpipe, "evaluate_generator", jax_evaluate)
    monkeypatch.setattr(jpipe, "cached_real_features", lambda *a, **k: None)
    import ic_gan_tpu.cli.inference as jinf

    monkeypatch.setattr(jinf, "make_conditioned_feature_fn", lambda *a: None)
    jcfg = dict(cfg, metrics_out=str(tmp_path / "jm.npy"), npz_path=str(tmp_path / "js.npz"))
    (tmp_path / "jcfg.json").write_text(json.dumps(jcfg))
    jtest.main(["--json_config", str(tmp_path / "jcfg.json")])
    jsaved = np.load(tmp_path / "jm.npy", allow_pickle=True).item()
    assert jsaved == saved
    jx = np.load(tmp_path / "js.npz")
    assert list(jx.keys()) == ["x"] and jx["x"].dtype == x.dtype
    np.testing.assert_array_equal(jx["x"], x)


SG2 = dict(img_resolution=16, z_dim=16, c_dim=0, h_dim=2048, w_dim=16,
           mapping_kwargs=dict(num_layers=2),
           synthesis_kwargs=dict(channel_base=256, channel_max=16, num_fp16_res=0,
                                 conv_clamp=256.0, architecture="skip"))
METRICS = ("fid50k_full", "kid50k_full", "pr50k3_full", "is50k", "ppl2_wend")


def _sg2_pickle(path):
    """A torch network snapshot of the port's instance-conditioned G from a
    seed, as ``load_network_pkl`` reads one (a dict of modules carrying
    their ``init_kwargs``)."""
    s = SG2["synthesis_kwargs"]
    cfg = tsg2.StyleGAN2Config(
        img_resolution=SG2["img_resolution"], z_dim=SG2["z_dim"], c_dim=0, h_dim=SG2["h_dim"],
        w_dim=SG2["w_dim"], channel_base=s["channel_base"], channel_max=s["channel_max"],
        num_mapping_layers=2, num_fp16_res=0)
    g = tsg2.Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(31))
    with torch.no_grad():      # layer noise on: its strengths start at 0
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
    g.init_kwargs = dict(SG2)
    with open(path, "wb") as f:
        pickle.dump({"G_ema": g}, f)
    return g


def test_calc_metrics_cli_equals_direct_calls_and_writes_jax_records(  # noqa: F811
        files, tmp_path, stand_in, monkeypatch):
    data = _data_root(files, tmp_path / "data")
    _sg2_pickle(tmp_path / "g.pkl")
    vgg = tvgg.VGG16(device="cpu", generator=torch.Generator().manual_seed(32))
    torch.save(vgg.state_dict(), tmp_path / "vgg.pth")
    monkeypatch.setenv("ICGAN_VGG16_WEIGHTS", str(tmp_path / "vgg.pth"))
    cfg = dict(backbone="stylegan2", network_pkl=str(tmp_path / "g.pkl"), resolution=RES,
               data_root=str(data), k_nn=K, seed=4, batch_size=4, num_inception_images=20,
               max_real_images=8, eval_batch_size=4, ppl_num_samples=8,
               metrics=",".join(METRICS), run_dir=str(tmp_path / "run"))
    got = tcalc.main(_argv(cfg, tmp_path / "cfg.json"))

    apply_fn, mcfg = tinf.load_model_inference(cfg, device="cpu")
    kw = split_config(cfg, inference=True)[3]
    dataset = tdata.get_dataset_hdf5(**dict(kw, instance_cond=True), device="cpu")
    sample = ttest.nchw(tinf.make_conditioned_sampler(cfg, apply_fn, mcfg, dataset))
    ev = StandInEvaluator()
    reals = tpipe.cached_real_features(dataset, ev, str(data / "feature_cache"), 8, batch=4)
    ref = np.load(data / tpipe.moments_filename(RES))
    g = apply_fn.module
    ppl_kw = dict(
        g_synthesize=lambda ws, generator=None: g.synthesize(ws, noise_mode="random",
                                                             generator=generator),
        map_ws=lambda z, feats=None: g.map_ws(z, None, feats), z_dim=16, num_samples=8,
        batch=4, feature_fn=tmetrics.make_lpips_feature_fn(device="cpu"), device="cpu",
        cond_sampler=lambda b: {"feats": torch.as_tensor(
            dataset.sample_conditioning_instance_balance(b)[1])})
    common = dict(evaluator=ev, sample_fn=sample, num_images=20, batch=4)
    want = {}
    for name, extra in (("fid50k_full", dict(ref_mu=ref["mu"], ref_sigma=ref["sigma"])),
                        ("kid50k_full", dict(real_features=reals)),
                        ("pr50k3_full", dict(real_features=reals)), ("is50k", {})):
        want.update(tmetrics.calc_metric(name, **common, **extra))
    want.update(tmetrics.calc_metric("ppl2_wend", **ppl_kw))
    assert got.keys() == want.keys() and got["ppl_distance"] == "lpips"
    for k, v in want.items():
        if k != "ppl_distance":
            assert np.isfinite(v) and got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    records = {m: [json.loads(line) for line in
                   (tmp_path / "run" / f"metric-{m}.jsonl").read_text().splitlines()]
               for m in METRICS}
    assert all(len(r) == 1 for r in records.values())

    # The JAX CLI over the port's results writes the same records.
    outs = {m: r[0]["results"] for m, r in records.items()}
    monkeypatch.setattr(jcalc, "load_model_inference", lambda c: (
        types.SimpleNamespace(module=None, variables=None), types.SimpleNamespace(
            z_dim=16, c_dim=0, h_dim=2048)))
    monkeypatch.setattr(jcalc, "make_conditioned_sampler", lambda *a, **k: None)
    import ic_gan_tpu.data.datasets as jdata_mod

    monkeypatch.setattr(jdata_mod, "get_dataset_hdf5", lambda **k: None)
    monkeypatch.setattr(jpipe, "InceptionEvaluator", lambda *a, **k: None)
    monkeypatch.setattr(jpipe, "cached_real_features", lambda *a, **k: None)
    monkeypatch.setattr(jmetrics_mod, "calc_metric", lambda name, **k: outs[name])
    monkeypatch.setattr(jmetrics_mod, "make_lpips_feature_fn", lambda *a: None)
    jcfg = dict(cfg, run_dir=str(tmp_path / "jrun"))
    (tmp_path / "jcfg.json").write_text(json.dumps(jcfg))
    jax_results = jcalc.main(["--json_config", str(tmp_path / "jcfg.json")])
    assert jax_results == got
    for m in METRICS:
        (rec,) = [json.loads(line) for line in
                  (tmp_path / "jrun" / f"metric-{m}.jsonl").read_text().splitlines()]
        assert rec.keys() == records[m][0].keys()
        assert {k: v for k, v in rec.items() if k != "timestamp"} == \
            {k: v for k, v in records[m][0].items() if k != "timestamp"}
