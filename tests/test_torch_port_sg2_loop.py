"""The port's StyleGAN2-ADA training loop against the JAX loop, on the CPU.

Schedule parity: the JAX ``SG2Trainer`` and the port's at the toy
configuration of ``tests/test_sg2_trainer.py``, each with its four step
variants replaced by stubs (no JAX train step compiles; the steps' numerics
are held by ``test_torch_port_sg2_train*.py``).  A stub records (step,
do_pl, do_r1), advances the image count by the batch and adds a fixed
real-sign sum, so ADA's controller moves p the same way on both sides.
Then the port's loop for real: four steps that run all four variants, its
logs, events, snapshot and profiler trace.
"""

import dataclasses
import json
import os

import flax.linen
import numpy as np
import pytest
import torch

import jax

from ic_gan_tpu.models import stylegan2 as jsg2
from ic_gan_tpu.train import stylegan2_step as jstep
from ic_gan_tpu.train import stylegan2_trainer as jtrainer
from ic_gan_tpu_torch.data.datasets import Batch
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.train import stylegan2_step as tstep
from ic_gan_tpu_torch.train import stylegan2_trainer as ttrainer
from ic_gan_tpu_torch.utils.tensorboard import read_scalar_events


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: its tensors are toy-sized,
    and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES, H_DIM, BATCH = 16, 12, 4
MODEL = dict(img_resolution=RES, z_dim=8, c_dim=0, h_dim=H_DIM, w_dim=16, channel_base=512,
             channel_max=32, num_fp16_res=0, conv_clamp=None, num_mapping_layers=2,
             mbstd_group_size=2)
TRAIN = dict(G_reg_interval=2, D_reg_interval=3, ada_interval=2, ada_kimg=0.01)


class ToyDataset:
    """Duck-typed like ``HDF5Dataset``: NCHW images in [-1, 1] and instance
    features from a seeded numpy generator."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def sample_batch(self, n):
        return Batch(self.rng.uniform(-1, 1, (n, 3, RES, RES)).astype(np.float32), None,
                     self.rng.standard_normal((n, H_DIM)).astype(np.float32), None)

    def sample_conditioning_instance_balance(self, n):
        return None, self.rng.standard_normal((n, H_DIM)).astype(np.float32)


def _sign(step):
    """The stubs' real-sign mean: above ADA's target 0.6 for 6 steps, then 0."""
    return 1.0 if step < 6 else 0.0


def _stub(do_pl, do_r1, log):
    def step(state, batch, rng):
        s = int(state.step)
        log.append((s, do_pl, do_r1))
        n = batch["x"].shape[0]
        state = dataclasses.replace(
            state, step=state.step + 1, cur_nimg=state.cur_nimg + n,
            ada_sign_sum=state.ada_sign_sum + _sign(s) * n, ada_count=state.ada_count + n)
        return state, {"G_loss": 0.25 * s, "D_loss": 1.0 + s}
    return step


def _run_stubbed(module, model_cfg, train_cfg, run_dir, monkeypatch):
    """Run ``module.SG2Trainer`` with stubbed steps for up to 20 steps; return what
    the loop did."""
    log, updates, saves, evals = [], [], [], []
    real_update, real_save = module.ada_update, module.save_checkpoint

    def ada_update(state, cfg, batch_size):
        state = real_update(state, cfg, batch_size)
        updates.append((int(state.step), float(state.ada_p)))
        return state

    def save_checkpoint(root, name, state, config=None, suffix=""):
        saves.append((int(state.step), name, config))
        return real_save(root, name, state, config=config, suffix=suffix)

    monkeypatch.setattr(module, "ada_update", ada_update)
    monkeypatch.setattr(module, "save_checkpoint", save_checkpoint)
    fids = [50.0, 40.0, 45.0, 47.0, 49.0, 51.0]

    def eval_fn(tr):
        evals.append(int(tr.state.step))
        return {"FID": fids[len(evals) - 1]}

    loop = module.SG2LoopConfig(
        run_dir=str(run_dir), batch_size=BATCH, kimg_per_tick=0.008, snapshot_ticks=2,
        augment_spec="color", early_stop_metric_ticks=2)
    kw = {} if module is jtrainer else {"device": "cpu"}
    tr = module.SG2Trainer(model_cfg, train_cfg, loop, ToyDataset(), eval_fn=eval_fn, **kw)
    tr.steps = {k: _stub(*k, log) for k in tr.steps}
    tr.run(max_steps=20)
    with open(os.path.join(tr.run_dir, "stats.jsonl")) as f:
        ticks = [{k: v for k, v in json.loads(line).items()
                  if k not in ("sec_per_kimg", "_stamp")} for line in f]
    dirs = sorted(d for d in os.listdir(tr.run_dir)
                  if os.path.isdir(os.path.join(tr.run_dir, d)) and d != "tb")
    return dict(variants=log, updates=updates, saves=saves, evals=evals, ticks=ticks,
                dirs=dirs, stop=int(tr.state.step), best=tr.best_fid)


def test_loop_schedule_matches_jax(tmp_path, monkeypatch):
    """Variant sequence, ADA updates and p after each (exact), tick records
    but their timing, snapshots, eval calls, the best FID and the early stop
    at step 16 (the fourth eval, the second without improvement)."""
    # The JAX networks' variables from their shapes (traced, not run): the
    # stubbed steps never read them, and an eager init compiles every op.
    def zeros_init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda: flax.linen.Module.init(self, rngs, *args, **kw))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)

    monkeypatch.setattr(jsg2.Generator, "init", zeros_init)
    monkeypatch.setattr(jsg2.Discriminator, "init", zeros_init)
    jax_run = _run_stubbed(jtrainer, jsg2.StyleGAN2Config(**MODEL),
                           jstep.SG2TrainConfig(**TRAIN), tmp_path / "jax", monkeypatch)
    port_run = _run_stubbed(ttrainer, tsg2.StyleGAN2Config(**MODEL),
                            tstep.SG2TrainConfig(**TRAIN), tmp_path / "port", monkeypatch)
    for key in ("variants", "updates", "saves", "evals", "ticks", "dirs", "stop", "best"):
        assert port_run[key] == jax_run[key], key
    assert port_run["stop"] == 16 and port_run["evals"] == [4, 8, 12, 16]
    assert {v[1:] for v in port_run["variants"]} == {(True, True), (False, False),
                                                     (True, False), (False, True)}
    assert port_run["dirs"] == ["best-network-snapshot", "network-snapshot"]
    ps = [p for _, p in port_run["updates"]]
    assert max(ps) > 0.0 and ps[-1] == 0.0          # p rose, then fell back to 0
    assert len(port_run["ticks"]) == 8 and port_run["ticks"][0]["kimg"] == 0.008


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    """Four real steps of the port's loop at the toy size, with a profiler
    window over the first two; G_reg_interval 2 and D_reg_interval 3 make
    steps 0-3 run pl+r1, main, pl and r1."""
    root = tmp_path_factory.mktemp("sg2_loop")
    loop = ttrainer.SG2LoopConfig(
        run_dir=str(root), batch_size=BATCH, kimg_per_tick=0.008, snapshot_ticks=2,
        augment_spec="color", augment_p_init=0.2, profile_dir=str(root / "prof"),
        profile_start=0, profile_steps=2)
    tr = ttrainer.SG2Trainer(tsg2.StyleGAN2Config(**MODEL), tstep.SG2TrainConfig(**TRAIN),
                             loop, ToyDataset(), device="cpu")
    ran = []

    def recording(key, fn):
        def step(state, batch, generator):
            ran.append(key)
            return fn(state, batch, generator)
        return step

    tr.steps = {k: recording(k, fn) for k, fn in tr.steps.items()}
    before = {k: v.detach().clone() for k, v in tr.state.g_ema.state_dict().items()}
    tr.run(max_steps=4)
    return dict(tr=tr, ran=ran, root=root, ema_before=before)


def test_real_loop_runs_every_variant_and_writes_stats_events_and_snapshot(real_run):
    tr = real_run["tr"]
    assert real_run["ran"] == [(True, True), (False, False), (True, False), (False, True)]
    assert tr.state.step == 4 and tr.state.cur_nimg == 4 * BATCH
    with open(os.path.join(tr.run_dir, "stats.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["kimg"] for r in recs] == [0.008, 0.016]
    for r in recs:
        assert np.isfinite([v for k, v in r.items() if k != "_stamp"]).all()
        assert {"G_loss", "D_loss", "augment_p", "sec_per_kimg", "real_signs"} <= set(r)
    assert "r1_penalty" in recs[1] and "pl_penalty" not in recs[1]   # step 3: r1
    (events,) = os.listdir(os.path.join(tr.run_dir, "tb"))
    scalars = read_scalar_events(os.path.join(tr.run_dir, "tb", events))
    assert {(s, t) for s, t, _ in scalars} >= {(8, "Progress/G_loss"), (16, "Progress/kimg")}
    snap = os.path.join(tr.run_dir, "network-snapshot")
    assert os.path.exists(os.path.join(snap, "state.pt"))
    with open(os.path.join(snap, "config.json")) as f:
        assert json.load(f)["kimg"] == 0.016
    after = tr.state.g_ema.state_dict()
    assert any(not torch.equal(after[k], v) for k, v in real_run["ema_before"].items())
    imgs, c, h = tr.sample_fn(3, torch.Generator().manual_seed(0), truncation_psi=0.7)
    assert imgs.shape == (3, 3, RES, RES) and c is None and h.shape == (3, H_DIM)
    assert torch.isfinite(imgs).all()


def test_profile_window_leaves_a_trace_of_the_phases(real_run):
    with open(os.path.join(real_run["root"], "prof", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sg2_step/main+pl+r1", "sg2_step/main"} <= names
    assert "sg2_step/main+pl" not in names          # step 2 is outside the window


def test_step_seed_depends_on_seed_and_step_alone():
    seeds = {ttrainer.step_seed(s, k) for s in (0, 1) for k in range(50)}
    assert len(seeds) == 100 and ttrainer.step_seed(3, 7) == ttrainer.step_seed(3, 7)
    assert all(0 <= s < 2 ** 63 for s in seeds)
