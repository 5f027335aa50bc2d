"""The port's BigGAN training loop (``train/trainer.py``, ``cli/train.py``,
``cli/config.py``, ``data/distributions.py``) against the JAX package's, on
the CPU.

- ``data/distributions.py``: the numpy samplers draw for draw, the torch
  samplers' dispatch and probabilities.
- Schedule parity: the JAX ``Trainer`` and the port's on one tiny HDF5 set
  (labels, features, k-NN), each with its train step replaced by a stub (no
  JAX step compiles; the steps' numerics are held by
  ``test_torch_port_train*.py``) and the JAX init by ``eval_shape`` zeros.
  Every batch ``make_batch`` gives (bit for bit, the per-epoch reseeds
  included), the saves and their configs, the rotating copies, the best
  copies and early stop from a scripted ``eval_fn``, the log cadence and
  the history.
- ``split_config`` against the JAX one.
- ``cli/train.py`` for real: four steps in two epochs of a toy cc_icgan
  model with DiffAugment, and the same run stopped after the first epoch
  and resumed, ending bit for bit in the same state; a profiler window.
"""

import dataclasses
import json
import os
import warnings

import flax.linen
import numpy as np
import pytest
import torch

import jax

from ic_gan_tpu.cli import config as jconfig
from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.data import distributions as jdist
from ic_gan_tpu.data import feature_bank as jbank
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu.train import step as jstep
from ic_gan_tpu.train import trainer as jtrainer
from ic_gan_tpu_torch.cli import config as tconfig
from ic_gan_tpu_torch.cli import train as tcli
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.data import distributions as tdist
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.train import step as tstep
from ic_gan_tpu_torch.train import trainer as ttrainer
from ic_gan_tpu_torch.utils.tensorboard import read_scalar_events
from test_torch_port_classcond import _one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

N, RES, F, K, NC, MB = 24, 32, 2048, 3, 5, 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """24 images at 32² with labels in 5 classes, 2048-d features and their
    k-NN file, under the reference's file names."""
    root = tmp_path_factory.mktemp("hdf5")
    rng = np.random.RandomState(0)
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    feats = rng.randn(N, F).astype(np.float32)
    with h5py.File(root / names["xy"], "w") as f:
        f.create_dataset("imgs", data=rng.randint(0, 256, (N, 3, RES, RES), dtype=np.uint8))
        f.create_dataset("labels", data=np.arange(N) % NC)
    with h5py.File(root / names["feats"], "w") as f:
        f.create_dataset("feats", data=feats)
    idx, radii = jbank.knn(feats / np.linalg.norm(feats, axis=1, keepdims=True), K + 1)
    with h5py.File(root / names["nns"], "w") as f:
        f.create_dataset("sample_nns", data=idx)
        f.create_dataset("sample_nns_radius", data=radii)
    return root


# --- distributions -----------------------------------------------------------------

@pytest.mark.parametrize("mode", [{}, dict(longtail_gen=True),
                                  dict(custom_distrib_gen=True, longtail_temperature=2.0),
                                  dict(constant_conditioning=True)])
def test_sample_gen_labels_and_balanced_weights_match_jax(mode):
    prob = np.array([0.5, 0.2, 0.2, 0.1, 0.0])
    j = jdist.sample_gen_labels(np.random.default_rng(3), 64, NC, class_prob=prob, **mode)
    t = tdist.sample_gen_labels(np.random.default_rng(3), 64, NC, class_prob=prob, **mode)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int64 and (not mode or (prob[t] > 0).all())
    labels = np.random.default_rng(4).choice(NC - 1, 40, p=prob[:4] / prob[:4].sum())
    np.testing.assert_array_equal(
        tdist.make_weights_for_balanced_classes(labels, NC, 1.5),
        jdist.make_weights_for_balanced_classes(labels, NC, 1.5))


def test_noise_and_class_samplers_dispatch_as_jax():
    """``prepare_z_y``'s dispatch and each class distribution's
    probabilities as JAX's; the torch draws in range and of the law."""
    prob = np.array([0.6, 0.3, 0.1, 0.0, 0.0])
    gen = torch.Generator().manual_seed(0)
    for kw in ({}, dict(longtail_gen=True), dict(custom_distrib=True, longtail_temperature=0.5)):
        jz, jy = jdist.prepare_z_y(16, NC, z_var=0.25, class_probabilities=prob, **kw)
        tz, ty = tdist.prepare_z_y(16, NC, z_var=0.25, class_probabilities=prob, **kw)
        assert (tz.dim_z, tz.var, ty.num_classes, ty.temperature) == (
            jz.dim_z, jz.var, jy.num_classes, jy.temperature)
        jp, tp = jy._probs(), ty.probs()
        assert (jp is None) == (tp is None)
        if tp is not None:
            np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-6)
        y = ty.sample(gen, 4000)
        assert y.dtype == torch.int64 and 0 <= y.min() and y.max() < NC
        if tp is not None:
            assert (y >= 3).sum() == 0
            assert abs((y == 0).float().mean().item() - tp[0]) < 0.03
        z = tz.sample(gen, 4000)
        assert z.shape == (4000, 16) and abs(z.var().item() - 0.25) < 0.02


# --- schedule parity with the steps stubbed ----------------------------------------------

def _zeros_init(self, rngs, *args, **kw):
    """The JAX networks' variables from their shapes (traced, not run): the
    stubbed step never reads them, and an eager init compiles every op."""
    shapes = jax.eval_shape(lambda: flax.linen.Module.init(self, rngs, *args, **kw))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


MODEL = dict(resolution=RES, G_ch=8, D_ch=8, G_attn="0", D_attn="0", dim_z=40, n_classes=NC,
             shared_dim=16, shared_dim_feat=16, class_cond=True)
TRAIN = dict(class_cond=True, num_D_steps=2, num_G_accumulations=2)


# Scripted evals: (FID, IS) per test and the trainer flags.  "patience": the
# best FID at the second eval, then two without a better one stop the run
# after epoch 4.  "diverge": 2·IS falls under the best IS at the third eval.
STOPS = {"patience": ([(50.0, 2.0), (40.0, 2.0), (45.0, 2.0), (47.0, 2.0)],
                      dict(es_patience=2), 8),
         "diverge": ([(50.0, 4.0), (45.0, 5.0), (44.0, 2.4)],
                     dict(es_patience=50, stop_when_diverge=True, which_best="IS"), 6)}


def _run_stubbed(module, model_cfg, train_cfg, files, root, monkeypatch, stop):
    """``module.Trainer`` on the tiny set for up to 4 epochs of 2 steps, its
    step a stub, evals scripted by ``STOPS[stop]``; returns what the loop
    did."""
    batches, saves, sheets, evals = [], [], [], []
    real_save = module.save_checkpoint

    def save_checkpoint(root_, name, state, config=None, suffix=""):
        saves.append((int(state.step), suffix, json.loads(json.dumps(config, default=str))))
        return real_save(root_, name, state, config=config, suffix=suffix)

    monkeypatch.setattr(module, "save_checkpoint", save_checkpoint)
    script, flags, _ = STOPS[stop]

    def eval_fn(tr):
        evals.append(tr.history["itr"])
        fid, is_mean = script[len(evals) - 1]
        return {"FID": fid, "IS_mean": is_mean}

    cfg = module.TrainerConfig(
        experiment_name="loop", weights_root=str(root / "w"), logs_root=str(root / "l"),
        num_epochs=4, test_every=1, num_save_copies=2, num_best_copies=2, seed=5,
        batch_size=MB, n_devices=1, log_every=3, sv_log_interval=2, log_G_spectra=True,
        enable_tb=False, **flags)
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    data_mod = jdata if module is jtrainer else tdata
    dataset = data_mod.HDF5Dataset(str(files / names["xy"]), str(files / names["feats"]),
                                   str(files / names["nns"]), k_nn=K, seed=9)
    kw = {} if module is jtrainer else {"device": "cpu"}
    tr = module.Trainer(model_cfg, train_cfg, cfg, dataset, eval_fn=eval_fn, **kw)

    def step(state, batch, rng):
        s = int(state.step)
        batches.append({k: np.array(v) for k, v in batch.items()})  # a copy: JAX reuses its slab
        state = (state.replace(step=state.step + 1) if module is jtrainer
                 else dataclasses.replace(state, step=state.step + 1))
        return state, {"G_loss": 0.25 * s, "D_loss_real": 1.0 + s}

    tr.step_fn = step
    monkeypatch.setattr(tr, "_save_progress_sheet", lambda n=16: sheets.append(tr.history["itr"]))
    tr.run(steps_per_epoch=2)
    logs = os.path.join(cfg.logs_root, "loop")
    with open(os.path.join(logs, "loop_log.jsonl")) as f:
        records = [{k: v for k, v in json.loads(line).items() if k != "_stamp"} for line in f]
    with open(os.path.join(logs, "loop_test_log.jsonl")) as f:
        tests = [{k: v for k, v in json.loads(line).items() if k != "_stamp"} for line in f]
    return dict(batches=batches, saves=saves, sheets=sheets, evals=evals, history=tr.history,
                records=records, tests=tests, dirs=sorted(os.listdir(cfg.weights_root)))


@pytest.mark.parametrize("stop", list(STOPS))
def test_loop_schedule_and_batches_match_jax(files, tmp_path, monkeypatch, stop):
    monkeypatch.setattr(jbiggan.Generator, "init", _zeros_init)
    monkeypatch.setattr(jbiggan.Discriminator, "init", _zeros_init)
    jrun = _run_stubbed(jtrainer, jbiggan.BigGANConfig(**MODEL), jstep.TrainConfig(**TRAIN),
                        files, tmp_path / "jax", monkeypatch, stop)
    trun = _run_stubbed(ttrainer, tbiggan.BigGANConfig(**MODEL), tstep.TrainConfig(**TRAIN),
                        files, tmp_path / "port", monkeypatch, stop)
    # Every batch, bit for bit (images NCHW in the port), every epoch's
    # reseed included, up to the scripted stop.
    assert len(trun["batches"]) == len(jrun["batches"]) == STOPS[stop][2]
    for jb, tb in zip(jrun["batches"], trun["batches"]):
        assert set(tb) == set(jb) == {"x", "label", "feats", "gen_label", "gen_feats"}
        assert tb["x"].shape == (2, MB, 3, RES, RES) and tb["gen_feats"].shape == (4, MB, F)
        np.testing.assert_array_equal(np.transpose(tb["x"], (0, 1, 3, 4, 2)), jb["x"])
        for k in ("label", "feats", "gen_label", "gen_feats"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert not np.array_equal(trun["batches"][0]["x"], trun["batches"][2]["x"])
    for key in ("saves", "sheets", "evals", "history", "tests", "dirs"):
        assert trun[key] == jrun[key], key
    # The log cadence: losses every 3 steps, G's singular values every 2
    # (the spectra flag selects G), with one value per SN layer on each side.
    assert [r["itr"] for r in trun["records"]] == [r["itr"] for r in jrun["records"]]
    for tr_, jr_ in zip(trun["records"], jrun["records"]):
        assert sorted(k.split("/")[0] for k in tr_) == sorted(k.split("/")[0] for k in jr_)
    assert trun["saves"][0][2]["dataset_rng_state"]["bit_generator"] == "PCG64"
    if stop == "patience":
        assert [s[1] for s in trun["saves"]] == ["", "copy0", "best0", "", "copy1", "best1",
                                                 "", "copy0", "", "copy1"]
        assert trun["history"]["epochs_no_improvement"] == 2
        assert trun["history"]["best_FID"] == 40.0
    else:   # the best IS copies at evals 1 and 2; at eval 3, 2·2.4 < 5 stops the run
        assert [s[1] for s in trun["saves"]] == ["", "copy0", "best0", "", "copy1", "best1",
                                                 "", "copy0"]
        assert trun["history"]["best_IS"] == 5.0 and trun["evals"] == [2, 4, 6]


def test_split_config_matches_jax():
    cfg = dict(resolution=128, G_ch=96, D_ch=96, G_attn="64", D_attn="64", hier=True,
               class_cond=True, instance_cond=True, G_shared_feat=True, shared_dim=128,
               shared_dim_feat=512, bf16=True, num_D_steps=1, batch_size=32, n_nodes=2,
               n_gpus_per_node=4, DA=True, DiffAugment="translation", ema=True,
               ema_start=2000, G_init="N02", which_loss="hinge", norm_style="gn_ch_8",
               longtail=True, which_knn_balance="nnclass_balance", k_nn=10, base_root="/r",
               use_ema=True, sv_log_interval=5, no_tb=True, G_nl="relu", seed=3)
    jm, jt, jtr, jd = jconfig.split_config(cfg)
    tm, tt, ttr, td = tconfig.split_config(cfg)
    for f in dataclasses.fields(tm):
        if f.name != "dtype":
            assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert tm.dtype == torch.bfloat16
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr)
    assert ttr.batch_size == 256 and ttr.experiment_name == tconfig.name_from_config(cfg) \
        == jconfig.name_from_config(cfg)
    assert td == jd
    # The warnings both packages give for the keys the port reads; another
    # app's key warns in the port's training config alone (JAX keeps one
    # registry for every app), and not where the apps' keys are known.
    bad = dict(cfg, G_nl="elu", no_such_key=1)
    with pytest.warns(UserWarning):
        assert tconfig.validate_config(bad, backbone="biggan") == jconfig.validate_config(bad)
    with pytest.warns(UserWarning, match="'prompt' would be dropped"):
        assert len(tconfig.validate_config(dict(cfg, prompt="a", max_steps=3),
                                           backbone="biggan")) == 2
    assert jconfig.validate_config(dict(cfg, prompt="a", max_steps=3)) == []
    assert tconfig.validate_config(dict(cfg, prompt="a", mode="interp"), backbone="biggan",
                                   inference=True) == []
    # An inference CLI's key warns in a training config and not in its own.
    with pytest.warns(UserWarning, match="'deploy_bf16' would be dropped"):
        tconfig.split_config(dict(cfg, deploy_bf16=True))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tconfig.validate_config(dict(cfg, deploy_bf16=True, num_samples=4),
                                       backbone="biggan", inference=True) == []
    assert tconfig.split_config(dict(cfg, profile_dir="/p", profile_start=2))[2].profile_dir \
        == "/p"
    # BigGAN-deep: the JAX package's deep config, field for field.
    deep = dict(cfg, model="BigGANdeep", G_depth=3)
    jdeep, tdeep = jconfig.split_config(deep)[0], tconfig.split_config(deep)[0]
    assert type(tdeep).__name__ == type(jdeep).__name__ == "BigGANDeepConfig"
    for f in dataclasses.fields(tdeep):
        if f.name != "dtype":
            assert getattr(tdeep, f.name) == getattr(jdeep, f.name), f.name
    assert (tdeep.G_depth, tdeep.effective_dim_z) == (3, jdeep.effective_dim_z)
    assert tconfig.validate_config({"exp_name": "x"}) == []      # the StyleGAN2 CLI's check


# --- the CLI for real --------------------------------------------------------------------

def _cli_config(files, root, **kw):
    cfg = dict(MODEL, instance_cond=True, G_shared_feat=True, hier=True, batch_size=MB,
               num_D_steps=1, DA=True, DiffAugment="color,translation,cutout", ema=True,
               ema_start=0, data_root=str(files), k_nn=K, experiment_name="cli",
               weights_root=str(root / "w"), logs_root=str(root / "l"), seed=1,
               # No per-epoch reseed: the sampler's stream runs on across the
               # epochs, so a resume must carry it.
               deterministic_run=False, num_epochs=2, steps_per_epoch=2, num_save_copies=1,
               test_every=100, log_every=1, sv_log_interval=2)
    cfg.update(kw)
    path = root / "cfg.json"
    root.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    return ["--json_config", str(path), "--device", "cpu"]


def _state_tensors(state):
    out = {}
    for key in ("g", "d", "g_ema", "g_opt", "d_opt"):
        sd = getattr(state, key).state_dict()
        if key.endswith("_opt"):
            sd = {f"{i}.{k}": t for i, st in sd["state"].items() for k, t in st.items()}
        out.update({f"{key}.{k}": t for k, t in sd.items()})
    return out


def test_cli_trains_saves_and_resumes_bit_for_bit(files, tmp_path, capsys):
    """Two epochs of two steps straight, and one epoch then a resume for the
    second: the same state bit for bit (CPU), history and dataset RNG
    carried by the snapshot; logs, events, copies and the progress sheet."""
    straight = tcli.main(_cli_config(files, tmp_path / "a"))
    assert "eval disabled" in capsys.readouterr().out
    first = tcli.main(_cli_config(files, tmp_path / "b", num_epochs=1))
    assert first.history["itr"] == 2 and first.history["epoch"] == 1
    resumed = tcli.main(_cli_config(files, tmp_path / "b", resume=True))
    assert straight.history == resumed.history and resumed.history["itr"] == 4
    a, b = _state_tensors(straight.state), _state_tensors(resumed.state)
    assert set(a) == set(b) and all(torch.equal(v, b[k]) for k, v in a.items())
    assert straight.state.step == resumed.state.step == 4
    assert straight.epoch_stats[1]["epoch"] == 1 and straight.epoch_stats[1]["img_per_s"] > 0

    w = tmp_path / "a" / "w"
    assert sorted(os.listdir(w)) == ["cli", "cli_copy0"]
    with open(w / "cli" / "config.json") as f:
        assert json.load(f)["history"]["itr"] == 4
    logs = tmp_path / "a" / "l" / "cli"
    with open(logs / "cli_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["itr"] for r in recs if "G_loss" in r] == [1, 2, 3, 4]
    assert sum(any(k.startswith("D_sv/") for k in r) for r in recs) == 2
    assert all(np.isfinite(r["G_loss"]) for r in recs if "G_loss" in r)
    (events,) = os.listdir(logs / "tb")
    assert {t for _, t, _ in read_scalar_events(str(logs / "tb" / events))} >= {
        "Loss/G_loss", "Loss/D_loss_real"}
    assert os.path.exists(logs / "fixed_samples_itr4.png")
    imgs, labels, feats = straight.sample_fn(3, torch.Generator().manual_seed(0))
    assert imgs.shape == (3, 3, RES, RES) and labels.shape == (3,) and feats.shape == (3, F)
    assert torch.isfinite(imgs).all()
    with pytest.raises(NotImplementedError, match="A.9"):
        tcli.main(_cli_config(files, tmp_path / "c", jax_distributed=True))


def test_cli_profile_window_leaves_a_trace_of_the_steps(files, tmp_path):
    """``profile_dir`` through the CLI: steps 1-3 of four traced to
    ``trace.json``, each inside a ``train_step`` range."""
    prof = tmp_path / "prof"
    tr = tcli.main(_cli_config(files, tmp_path, num_epochs=2, profile_dir=str(prof),
                               profile_start=1, no_tb=True))
    assert tr.history["itr"] == 4
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 3
