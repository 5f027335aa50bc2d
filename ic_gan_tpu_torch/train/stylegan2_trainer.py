"""StyleGAN2-ADA trainer: port of ``ic_gan_tpu/train/stylegan2_trainer.py``.

A tick-based loop with lazy-regularization phase scheduling, ADA p-control,
snapshots and FID-based early stopping (reference
``training/training_loop.py:108-730``):

- phase schedule: Gmain every step, +PL every ``G_reg_interval``-th, Dmain
  every step, +R1 every ``D_reg_interval``-th (ref ``:319-345``): four step
  variants of ``make_sg2_train_step``;
- ADA p adjustment every ``ada_interval`` steps from the real-sign sum (ref
  ``:542-551``);
- tick reports (kimg, sec/kimg, augment p) to ``stats.jsonl`` and
  TensorBoard, snapshot and metric eval per ``snapshot_ticks`` ticks,
  best-FID tracking and early stop (ref ``:563-686``).

Each step's random draws come from a ``torch.Generator`` on the device
seeded from ``(seed, step)`` alone (``step_seed``), the counterpart of the
JAX loop's ``fold_in(PRNGKey(seed), step)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.io.checkpoint import save_checkpoint
from ic_gan_tpu_torch.models import stylegan2 as sg2
from ic_gan_tpu_torch.train.stylegan2_step import (
    SG2TrainConfig,
    SG2TrainState,
    ada_update,
    make_sg2_train_step,
)
from ic_gan_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class SG2LoopConfig:
    experiment_name: str = "icgan_stylegan2"
    run_dir: str = "training-runs"
    total_kimg: int = 25000
    kimg_per_tick: float = 4
    snapshot_ticks: int = 50
    batch_size: int = 32
    ada_enabled: bool = True
    augment_spec: str = "bgc"
    augment_p_init: float = 0.0
    seed: int = 0
    early_stop_metric_ticks: Optional[int] = None  # FID patience in evals
    # TensorBoard event files next to stats.jsonl (ref
    # training_loop.py:389-396,698-715; native writer).
    enable_tb: bool = True
    # torch.profiler window (ref annotates every phase: torch_utils/misc.py:
    # 136-142 and training_loop.py:346-351).  When set, steps
    # [profile_start, profile_start + profile_steps) are traced to
    # profile_dir/trace.json, each step inside record_function
    # "sg2_step/<phase>", phase main, main+pl, main+r1 or main+pl+r1.
    profile_dir: Optional[str] = None
    profile_start: int = 12
    profile_steps: int = 3


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a hash of (seed, step) alone."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class SG2Trainer:
    """G, D, their train state and the loop, on ``device`` (CUDA unless
    named).  ``dataset`` has ``sample_batch(n)`` (images, labels, features;
    an ``HDF5Dataset`` or any object with the same two methods) and
    ``sample_conditioning_instance_balance(n)``; ``eval_fn(trainer)``
    returns metrics, ``FID`` among them, after every snapshot."""

    def __init__(
        self,
        model_cfg: sg2.StyleGAN2Config,
        train_cfg: SG2TrainConfig,
        loop_cfg: SG2LoopConfig,
        dataset,
        eval_fn: Optional[Callable] = None,
        device=None,
    ):
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.cfg = loop_cfg
        self.dataset = dataset
        self.eval_fn = eval_fn
        self.device = resolve_device(device)

        init = torch.Generator(device=self.device).manual_seed(loop_cfg.seed)
        self.g = sg2.Generator(model_cfg, device=self.device, generator=init)
        self.d = sg2.Discriminator(model_cfg, device=self.device, generator=init)

        self.augment_pipe = None
        if loop_cfg.ada_enabled or loop_cfg.augment_p_init > 0:
            self.augment_pipe = AugmentPipe.from_spec(loop_cfg.augment_spec)

        # The four phase variants (ref phases list :319-345).
        self.steps = {
            (do_pl, do_r1): make_sg2_train_step(train_cfg, model_cfg.z_dim, do_pl=do_pl,
                                                do_r1=do_r1, augment_fn=self.augment_pipe)
            for do_pl in (False, True) for do_r1 in (False, True)
        }
        self.state = SG2TrainState.create(
            self.g, self.d, dataclasses.replace(train_cfg, augment_p=loop_cfg.augment_p_init))
        self.generator = torch.Generator(device=self.device)

        self.run_dir = os.path.join(loop_cfg.run_dir, loop_cfg.experiment_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.stats_log = MetricsLogger(os.path.join(self.run_dir, "stats.jsonl"))
        self.metric_log = MetricsLogger(os.path.join(self.run_dir, "metric-fid.jsonl"))
        self.tb = None
        if loop_cfg.enable_tb:
            from ic_gan_tpu_torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(os.path.join(self.run_dir, "tb"))
        self.best_fid = float("inf")
        self.evals_no_improvement = 0

    def _put(self, a):
        return torch.as_tensor(a, device=self.device)

    def make_batch(self) -> dict:
        b = self.dataset.sample_batch(self.cfg.batch_size)
        batch = {"x": self._put(b.images)}
        # One joint instance draw: the generator's (label, feature) pairs
        # come from the same instance (ref training_loop.py:448-455 samples
        # both from one dataset index).
        gen_label = gen_h = None
        if self.mcfg.h_dim or self.mcfg.c_dim:
            gen_label, gen_h = self.dataset.sample_conditioning_instance_balance(
                self.cfg.batch_size)
        if self.mcfg.h_dim:
            batch["h"] = self._put(b.features)
            batch["gen_h"] = self._put(gen_h)
        if self.mcfg.c_dim:
            batch["c"] = self._put(b.labels)
            batch["gen_c"] = self._put(gen_label)
        return batch

    def step_generator(self, step: int) -> torch.Generator:
        """The device generator, seeded for step ``step``."""
        return self.generator.manual_seed(step_seed(self.cfg.seed, step))

    def run(self, max_steps: Optional[int] = None):
        cfg = self.cfg
        t = self.tcfg
        step = 0
        tick = 0
        tick_start = time.time()
        tick_start_nimg = 0
        total_steps = (max_steps if max_steps is not None
                       else cfg.total_kimg * 1000 // cfg.batch_size)
        prof = None
        try:
            while step < total_steps:
                if cfg.profile_dir and step == cfg.profile_start:
                    prof = self._start_profile()
                batch = self.make_batch()
                do_pl = (step % t.G_reg_interval) == 0 and t.pl_weight != 0
                do_r1 = (step % t.D_reg_interval) == 0 and t.r1_gamma != 0
                phase = "+".join(["main"] + (["pl"] if do_pl else []) + (["r1"] if do_r1 else []))
                with (torch.profiler.record_function(f"sg2_step/{phase}") if prof
                      else contextlib.nullcontext()):
                    self.state, metrics = self.steps[(do_pl, do_r1)](
                        self.state, batch, self.step_generator(step))
                step += 1
                if prof is not None and step == cfg.profile_start + cfg.profile_steps:
                    self._stop_profile(prof)
                    prof = None
                if cfg.ada_enabled and step % t.ada_interval == 0:
                    self.state = ada_update(self.state, t, cfg.batch_size)

                cur_nimg = int(self.state.cur_nimg)
                if cur_nimg >= (tick + 1) * cfg.kimg_per_tick * 1000 or step == total_steps:
                    dt = time.time() - tick_start
                    sec_per_kimg = dt / max((cur_nimg - tick_start_nimg) / 1000, 1e-8)
                    rec = {
                        "kimg": cur_nimg / 1000,
                        "sec_per_kimg": sec_per_kimg,
                        "augment_p": float(self.state.ada_p),
                        **{k: float(v) for k, v in metrics.items()},
                    }
                    self.stats_log.log(rec)
                    if self.tb:
                        # The reference tags events by nimg (training_loop.py:707).
                        self.tb.add_scalars({f"Progress/{k}": v for k, v in rec.items()},
                                            cur_nimg)
                    print(f"tick {tick} kimg {rec['kimg']:.1f} {sec_per_kimg:.1f}s/kimg "
                          f"p={rec['augment_p']:.3f} G={rec.get('G_loss', 0):.3f} "
                          f"D={rec.get('D_loss', 0):.3f}")
                    tick += 1
                    tick_start = time.time()
                    tick_start_nimg = cur_nimg

                    if tick % cfg.snapshot_ticks == 0 or step == total_steps:
                        if self._snapshot(cur_nimg):
                            print("Early stopping on FID.")
                            return
        finally:
            if prof is not None:
                self._stop_profile(prof)

    def _snapshot(self, cur_nimg: int) -> bool:
        """Save a snapshot, run ``eval_fn``, keep the best; True to stop early."""
        cfg = self.cfg
        save_checkpoint(self.run_dir, "network-snapshot", self.state,
                        config={"kimg": cur_nimg / 1000, "best_fid": self.best_fid})
        if self.eval_fn is None:
            return False
        m = self.eval_fn(self)
        self.metric_log.log({"results": m, "snapshot_kimg": cur_nimg / 1000})
        if self.tb:
            self.tb.add_scalars({f"Metrics/{k}": v for k, v in m.items()}, cur_nimg)
        fid = m.get("FID", float("inf"))
        if fid < self.best_fid:
            self.best_fid = fid
            self.evals_no_improvement = 0
            save_checkpoint(self.run_dir, "best-network-snapshot", self.state,
                            config={"best_fid": fid, "kimg": cur_nimg / 1000})
            return False
        self.evals_no_improvement += 1
        return (cfg.early_stop_metric_ticks is not None
                and self.evals_no_improvement >= cfg.early_stop_metric_ticks)

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.cfg.profile_dir, "trace.json"))

    @torch.no_grad()
    def sample_fn(self, n: int, generator: Optional[torch.Generator] = None,
                  truncation_psi: float = 1.0):
        """EMA G samples with dataset conditioning (for eval): z from
        ``generator`` (on the device), constant layer noise.  Returns
        (images NCHW, c, h)."""
        z = torch.randn((n, self.mcfg.z_dim), generator=generator, device=self.device)
        c = h = None
        if self.mcfg.h_dim or self.mcfg.c_dim:
            lab, feats = self.dataset.sample_conditioning_instance_balance(n)
            if self.mcfg.h_dim:
                h = self._put(feats)
            if self.mcfg.c_dim and lab is not None:
                c = self._put(lab)
        imgs = self.state.g_ema(z, c, h, truncation_psi=truncation_psi, noise_mode="const")
        return imgs, c, h
