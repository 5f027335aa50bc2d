"""BigGAN/IC-GAN trainer: port of ``ic_gan_tpu/train/trainer.py``.

The epoch loop, eval, checkpoints and early stopping of
``BigGAN_PyTorch/trainer.py:41-541``, on one device or, with a process
group up (``parallel.mesh.distributed_init``), data-parallel over its ranks:

- per-epoch loop over host-sampled batches (the dataset's conditioning
  draws stay numpy, as the JAX trainer's and the reference's DataLoader);
- deterministic reseed of the dataset per epoch (ref ``trainer.py:113-119``)
  and each step's draws (z, DiffAugment) from a device ``torch.Generator``
  seeded from ``(seed, itr)`` alone (``train.state.step_seed``);
- test every ``test_every`` epochs through a pluggable ``eval_fn``,
  best-checkpoint save on IS or FID (ref ``train_fns.py:290-362``), early
  stop on FID patience and divergence stop when ``2·IS < best_IS`` (ref
  ``trainer.py:514-540``);
- rotating ``copy%d`` saves (ref ``train_fns.py:219-236``).

The model config picks the backbone: BigGAN or BigGAN-deep
(``models.biggan_deep.model_classes``).  Data parallelism follows the JAX
trainer's mesh and multi-host feeding: ``batch_size`` is the global
microbatch and each rank draws its share from a dataset stream seeded with
``seed + 100003·rank``; the state is broadcast from rank 0 after init and
load, the step runs over the mesh (``train.step``), only rank 0 evaluates
(its IS and FID are broadcast to every rank) and only rank 0 writes
checkpoints, logs and sheets.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ic_gan_tpu_torch.io.deploy import accumulate_standing_stats, fold_spectral_norm
from ic_gan_tpu_torch.models.biggan import BigGANConfig
from ic_gan_tpu_torch.models.biggan_deep import model_classes
from ic_gan_tpu_torch.models.layers import apply_weight_init
from ic_gan_tpu_torch.parallel.mesh import (
    broadcast_one_to_all,
    is_main_process,
    local_batch_size,
    make_mesh,
    process_count,
    process_index,
    replicated,
)
from ic_gan_tpu_torch.train.state import GANTrainState, start_profile, step_seed, stop_profile
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
from ic_gan_tpu_torch.utils.logging import MetricLogger, MetricsLogger, write_metadata


@dataclasses.dataclass
class TrainerConfig:
    experiment_name: str = "icgan_experiment"
    weights_root: str = "weights"
    logs_root: str = "logs"
    num_epochs: int = 100
    test_every: int = 5
    save_every: int = 1
    num_save_copies: int = 2
    num_best_copies: int = 2
    which_best: str = "FID"
    es_patience: int = 50
    seed: int = 0
    deterministic_run: bool = True
    batch_size: int = 64          # per microbatch (per accumulation), global
    # The data mesh's size: None (or the process group's size) runs one
    # rank per process of the group, 1 a single process.
    n_devices: Optional[int] = None
    # Reference eval-mode flags (utils.py:508-537): sample from the EMA copy,
    # and accumulate standing BN statistics before each eval.
    use_ema: bool = True
    accumulate_stats: bool = False
    num_standing_accumulations: int = 16
    # Divergence stop gate (ref trainer.py:514: only with stop_when_diverge).
    stop_when_diverge: bool = False
    # Log spectral-norm singular-value estimates every N iterations (ref
    # utils.py:1590-1598); 0 disables unless a log_*_spectra flag is set,
    # then the reference default interval 10 applies.  log_G_spectra /
    # log_D_spectra select which net's values are logged.
    sv_log_interval: int = 0
    log_G_spectra: bool = False
    log_D_spectra: bool = False
    # Train-metrics jsonl cadence (the reference writes every iteration,
    # trainer.py:468); each record reads the metrics back from the device.
    log_every: int = 100
    # Weight-init styles (ref ``init_weights``, BigGAN.py:294-345): "ortho"
    # (the construction default), "N02", "glorot"/"xavier"; ``skip_init``
    # skips the re-draw (ref utils.py:382-388).
    G_init: str = "ortho"
    D_init: str = "ortho"
    skip_init: bool = False
    # Generator label distribution for class-conditional models without
    # instance features (ref ``prepare_z_y`` + ``sample_conditioning_values``,
    # ``data_utils/utils.py:830-1016``; wiring ``trainer.py:264-334``).
    longtail_gen: bool = False
    custom_distrib_gen: bool = False
    longtail_temperature: float = 1.0
    constant_conditioning: bool = False
    # Optional npy of per-class probabilities; default: the dataset's
    # empirical label distribution.
    class_probabilities: Optional[str] = None
    # Conditioning-draw balancing (ref trainer.py:336-371, gated on
    # longtail & use_balanced_sampler & instance_cond).
    longtail: bool = False
    use_balanced_sampler: bool = False
    # Informational: the reference world size the batch came from.
    world_size: int = 1
    # TensorBoard event files next to the jsonl logs (native writer).
    enable_tb: bool = True
    # torch.profiler window: iterations [profile_start, profile_start + 3)
    # traced to profile_dir/trace.json, each step inside record_function
    # "train_step".
    profile_dir: Optional[str] = None
    profile_start: int = 10


class _NoLog:
    """The loggers of a rank that writes nothing."""

    def log(self, *args, **kwargs):
        pass


class Trainer:
    """Drives IC-GAN BigGAN training end to end on ``device`` (CUDA unless
    named), data-parallel when a process group is up.  ``dataset`` is an
    ``HDF5Dataset`` or an object with its sampling methods and ``rng``."""

    def __init__(
        self,
        model_cfg: BigGANConfig,
        train_cfg: TrainConfig,
        trainer_cfg: TrainerConfig,
        dataset,
        eval_fn: Optional[Callable] = None,
        sampling_weights: Optional[np.ndarray] = None,
        device=None,
    ):
        generator_cls, discriminator_cls = model_classes(model_cfg)
        if trainer_cfg.n_devices not in (None, process_count()):
            raise ValueError(
                f"n_devices {trainer_cfg.n_devices}: the trainer runs one rank per process "
                f"of the process group ({process_count()}); launch one process per device "
                "(parallel.mesh.distributed_init)")
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.cfg = trainer_cfg
        self.dataset = dataset
        self.eval_fn = eval_fn
        self.sampling_weights = sampling_weights
        self.device = resolve_device(device)
        self.mesh = make_mesh(device=self.device) if dist.is_initialized() else None
        self.rank, self.is_main = process_index(), is_main_process()
        local_batch_size(trainer_cfg.batch_size)    # raises unless it divides over the ranks

        init = torch.Generator(device=self.device).manual_seed(trainer_cfg.seed)
        self.g = generator_cls(model_cfg, device=self.device, generator=init)
        self.d = discriminator_cls(model_cfg, device=self.device, generator=init)
        if not trainer_cfg.skip_init:
            apply_weight_init(self.g, trainer_cfg.G_init, init)
            apply_weight_init(self.d, trainer_cfg.D_init, init)
        self.state = GANTrainState.create(
            self.g, self.d, train_cfg.g_optimizer(), train_cfg.d_optimizer())
        self.step_fn = make_train_step(train_cfg, model_cfg.effective_dim_z, mesh=self.mesh)
        self.generator = torch.Generator(device=self.device)
        if self.mesh is not None:
            self._replicate()
            # Each rank draws its own rows (ref trainer.py:113-119 seeds
            # with the rank).
            self.dataset.rng = np.random.default_rng(trainer_cfg.seed + 100003 * self.rank)

        # Conditioning-draw weights (ref trainer.py:336-371), apart from the
        # real-batch balanced sampler: nnclass_balance takes per-class
        # probabilities, the reference's softmax of the raw probabilities
        # (exp(p/T), its quirk); instance balance the per-sample weights.
        self.cond_weights = None
        if (trainer_cfg.longtail and trainer_cfg.use_balanced_sampler
                and model_cfg.instance_cond):
            if dataset.which_nn_balance == "nnclass_balance":
                w = np.exp(self._class_probabilities() / trainer_cfg.longtail_temperature)
                self.cond_weights = w / w.sum()
            else:
                self.cond_weights = sampling_weights

        self.history: Dict[str, Any] = {
            "itr": 0, "epoch": 0, "best_IS": 0.0, "best_FID": float("inf"),
            "save_num": 0, "save_best_num": 0, "epochs_no_improvement": 0,
        }
        # (epoch, seconds, img/s) of each epoch run, the saves left out.
        self.epoch_stats = []
        self.tb = None
        if not self.is_main:
            self.train_log = self.test_log = self.metric_log = _NoLog()
            return
        os.makedirs(trainer_cfg.weights_root, exist_ok=True)
        logs_dir = os.path.join(trainer_cfg.logs_root, trainer_cfg.experiment_name)
        os.makedirs(logs_dir, exist_ok=True)
        name = trainer_cfg.experiment_name
        self.train_log = MetricsLogger(os.path.join(logs_dir, f"{name}_log.jsonl"))
        self.test_log = MetricsLogger(os.path.join(logs_dir, f"{name}_test_log.jsonl"))
        self.metric_log = MetricLogger(logs_dir)
        if trainer_cfg.enable_tb:
            from ic_gan_tpu_torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(os.path.join(logs_dir, "tb"))
        write_metadata(
            logs_dir, name,
            {"model": dataclasses.asdict(model_cfg) | {"dtype": str(model_cfg.dtype)},
             "train": dataclasses.asdict(train_cfg),
             "trainer": dataclasses.asdict(trainer_cfg)},
        )

    def _replicate(self):
        """The state as rank 0 holds it, on every rank (the optimizers'
        moments are empty after init and read from one file on load)."""
        replicated(self.mesh, self.state.g, self.state.d, self.state.g_ema)

    # -- data ---------------------------------------------------------------

    def _class_probabilities(self) -> np.ndarray:
        """Per-class probabilities: the ``class_probabilities`` npy when
        given, else the dataset's empirical label distribution."""
        cached = getattr(self, "_class_prob_cache", None)
        if cached is not None:
            return cached
        if self.cfg.class_probabilities:
            p = np.load(self.cfg.class_probabilities, allow_pickle=False)
            p = np.asarray(p, np.float64).reshape(-1)
        else:
            labels = self.dataset.get_label(self.dataset.possible_sampling_idxs)
            p = np.bincount(np.asarray(labels).reshape(-1),
                            minlength=self.mcfg.n_classes).astype(np.float64)
        p = p / p.sum()
        self._class_prob_cache = p
        return p

    def _sample_gen_labels(self, n: int) -> np.ndarray:
        """Generator labels for class-only models (ref
        ``sample_conditioning_values``, ``utils.py:879-890``)."""
        from ic_gan_tpu_torch.data.distributions import sample_gen_labels

        c = self.cfg
        needs_probs = c.longtail_gen or c.custom_distrib_gen
        return sample_gen_labels(
            self.dataset.rng, n, self.mcfg.n_classes,
            longtail_gen=c.longtail_gen,
            custom_distrib_gen=c.custom_distrib_gen,
            longtail_temperature=c.longtail_temperature,
            constant_conditioning=c.constant_conditioning,
            class_prob=self._class_probabilities() if needs_probs else None,
        )

    def _sample_gen_conditioning(self, n: int):
        """One (labels, feats) generator-conditioning draw: the dataset's
        samplers when instance features condition the model, the y
        distribution otherwise (ref ``utils.py:879-901``)."""
        if self.mcfg.instance_cond:
            if self.dataset.which_nn_balance == "instance_balance":
                return self.dataset.sample_conditioning_instance_balance(n, self.cond_weights)
            return self.dataset.sample_conditioning_nnclass_balance(
                n, self.cond_weights, num_classes=self.mcfg.n_classes)
        if self.mcfg.class_cond:
            return self._sample_gen_labels(n), None
        return None, None

    def _stack(self, items) -> torch.Tensor:
        if torch.is_tensor(items[0]):
            return torch.stack(items).to(self.device)
        return torch.as_tensor(np.stack(items), device=self.device)

    def make_batch(self) -> dict:
        """The slab batch of the train step: nD microbatches of reals and
        nD + accG fresh generator conditionings (ref ``train_fns.py:62-163``),
        drawn in the JAX trainer's order, on the device: this rank's share
        of the global microbatch."""
        t = self.tcfg
        mb = local_batch_size(self.cfg.batch_size)
        nD = t.num_D_steps * t.num_D_accumulations
        images, labels, feats = [], [], []
        for _ in range(nD):
            b = self.dataset.sample_batch(mb, weights=self.sampling_weights)
            images.append(b.images)
            labels.append(b.labels)
            feats.append(b.features)
        batch = {"x": self._stack(images)}
        if self.mcfg.class_cond:
            batch["label"] = self._stack(labels)
        if self.mcfg.instance_cond:
            batch["feats"] = self._stack(feats)
        gl, gf = [], []
        for _ in range(nD + t.num_G_accumulations):
            labels_g, f_g = self._sample_gen_conditioning(mb)
            gl.append(labels_g)
            gf.append(f_g)
        if self.mcfg.class_cond:
            batch["gen_label"] = self._stack(gl)
        if self.mcfg.instance_cond:
            batch["gen_feats"] = self._stack(gf)
        return batch

    def step_generator(self, itr: int) -> torch.Generator:
        """The device generator, seeded for iteration ``itr``."""
        return self.generator.manual_seed(step_seed(self.cfg.seed, itr))

    # -- eval / save --------------------------------------------------------

    def _eval_variables(self, use_ema: bool = True):
        """The JAX trainer's eval variables, here an eval-mode copy of G (the
        EMA one with ``use_ema``) with spectral norm folded into its weights;
        with ``accumulate_stats``, standing statistics accumulated first
        (``G_eval_mode``, ref utils.py:1679-1695).  Cached per (step,
        use_ema)."""
        key = (int(self.state.step), use_ema)
        cache = getattr(self, "_eval_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        self._eval_cache = None
        src = self.state.g_ema if use_ema else self.state.g
        g = fold_spectral_norm(copy.deepcopy(src).eval().requires_grad_(False))
        if self.cfg.accumulate_stats:
            accumulate_standing_stats(
                g, torch.Generator(device=self.device).manual_seed(self.cfg.seed),
                self._sample_conditioning, batch_size=self.cfg.batch_size,
                n_accumulations=self.cfg.num_standing_accumulations)
        self._eval_cache = (key, g)
        return g

    def _sample_conditioning(self, n: int):
        labels, feats = self._sample_gen_conditioning(n)
        return (labels if self.mcfg.class_cond else None,
                feats if self.mcfg.instance_cond else None)

    def _sv_nets(self):
        """Which nets' spectra to log: the log_*_spectra flags select; with
        only sv_log_interval set, both."""
        cfg = self.cfg
        if cfg.log_G_spectra or cfg.log_D_spectra:
            return tuple(p for p, on in (("G", cfg.log_G_spectra),
                                         ("D", cfg.log_D_spectra)) if on)
        return ("G", "D")

    def _sv_interval(self) -> int:
        cfg = self.cfg
        if cfg.sv_log_interval > 0:
            return cfg.sv_log_interval
        return 10 if (cfg.log_G_spectra or cfg.log_D_spectra) else 0

    def _sv_metrics(self, nets=("G", "D")) -> Dict[str, float]:
        """Each layer's singular-value estimates, its ``sv0`` buffer (ref
        ``utils.py:1590-1598``)."""
        out = {}
        for prefix in nets:
            net = self.state.g if prefix == "G" else self.state.d
            for name, buf in net.named_buffers():
                if name.endswith("sv0"):
                    for i, v in enumerate(buf.tolist()):
                        out[f"{prefix}_sv/{name}_{i}"] = v
        return out

    @torch.no_grad()
    def sample_fn(self, n: int, generator: Optional[torch.Generator] = None,
                  use_ema: Optional[bool] = None):
        """``n`` images (NCHW, float32) with fresh conditioning, from the
        folded eval G, z from ``generator`` (on the device).  Returns
        (images, labels, feats), the conditioning as drawn."""
        if use_ema is None:
            use_ema = self.cfg.use_ema
        g = self._eval_variables(use_ema)
        labels, feats = self._sample_conditioning(n)
        z = torch.randn((n, self.mcfg.effective_dim_z), generator=generator,
                        device=self.device) * float(np.sqrt(self.tcfg.z_var))
        put = lambda a: None if a is None else torch.as_tensor(a, device=self.device)  # noqa: E731
        return g(z, put(labels), put(feats)), labels, feats

    def test(self):
        if self.eval_fn is None:
            return None
        # Eval runs on rank 0 only (every rank holds its state); the verdicts
        # are broadcast, so every rank takes the same best-copy and stop
        # decisions (the JAX trainer's ``test``).
        metrics = self.eval_fn(self) if self.is_main else None
        vals = ([metrics.get("IS_mean", 0.0), metrics.get("FID", float("inf"))]
                if metrics is not None else [0.0, 0.0])
        is_mean, fid = (float(v) for v in broadcast_one_to_all(vals, self.device))
        if metrics is None:
            metrics = {"IS_mean": is_mean, "FID": fid}
        h = self.history
        improved = ((self.cfg.which_best == "IS" and is_mean > h["best_IS"])
                    or (self.cfg.which_best == "FID" and fid < h["best_FID"]))
        if improved:
            h["epochs_no_improvement"] = 0
            self.save(suffix=f"best{h['save_best_num']}")
            h["save_best_num"] = (h["save_best_num"] + 1) % self.cfg.num_best_copies
        else:
            h["epochs_no_improvement"] += 1
        h["best_IS"] = max(h["best_IS"], is_mean)
        h["best_FID"] = min(h["best_FID"], fid)
        self.test_log.log(itr=h["itr"], **metrics)
        self.metric_log.log(h["itr"], **metrics)
        if self.tb:
            self.tb.add_scalars(
                {f"Metrics/{k}": v for k, v in metrics.items() if np.isscalar(v)}, h["itr"])
        return metrics

    def save(self, suffix: str = ""):
        if not self.is_main:
            return
        save_checkpoint(
            self.cfg.weights_root, self.cfg.experiment_name, self.state,
            config={"history": dict(self.history),
                    "best_FID": self.history["best_FID"],
                    "best_IS": self.history["best_IS"],
                    # The sampler's state, for an exact mid-run resume (the
                    # reference replays its RNG to the resume point).
                    "dataset_rng_state": self.dataset.rng.bit_generator.state},
            suffix=suffix,
        )

    def resume(self, suffix: str = ""):
        self.state, cfg = load_checkpoint(
            self.cfg.weights_root, self.cfg.experiment_name, self.state, suffix)
        if cfg and "history" in cfg:
            self.history.update(cfg["history"])
        # The saved stream is rank 0's: the other ranks keep their own until
        # the next epoch's reseed (the JAX trainer gives every host rank 0's).
        if cfg and cfg.get("dataset_rng_state") and self.is_main:
            self.dataset.rng.bit_generator.state = cfg["dataset_rng_state"]
        if self.mesh is not None:
            self._replicate()

    def _save_progress_sheet(self, n: int = 16):
        """A fixed-seed sample grid per save (ref ``save_and_sample``
        fixed_z sheets, ``train_fns.py:245-281``), on rank 0.  Needs PIL;
        without it, or on any other failure, the sheet is skipped and
        training goes on."""
        if not self.is_main:
            return
        try:
            from ic_gan_tpu_torch.cli.inference import save_image_grid

            fixed = getattr(self, "_fixed_cond", None)
            if fixed is None:
                # Drawn from a stream of its own, seeded from the run's seed,
                # so the sampler's stream stays where the save recorded it
                # and a resumed run draws the batches a straight one does
                # (the JAX trainer draws the sheet from the sampler's
                # stream: ROADMAP.md §C).
                live, self.dataset.rng = self.dataset.rng, np.random.default_rng(self.cfg.seed)
                try:
                    if self.dataset.which_nn_balance == "instance_balance":
                        labels, feats = self.dataset.sample_conditioning_instance_balance(n)
                    else:
                        labels, feats = self.dataset.sample_conditioning_nnclass_balance(
                            n, num_classes=self.mcfg.n_classes)
                finally:
                    self.dataset.rng = live
                z = torch.randn((n, self.mcfg.effective_dim_z), device=self.device,
                                generator=torch.Generator(device=self.device).manual_seed(
                                    self.cfg.seed)) * float(np.sqrt(self.tcfg.z_var))
                fixed = (z, labels, feats)
                self._fixed_cond = fixed
            z, labels, feats = fixed
            put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            with torch.no_grad():
                imgs = self._eval_variables(use_ema=True)(
                    z, put(labels) if self.mcfg.class_cond else None,
                    put(feats) if self.mcfg.instance_cond else None)
            path = os.path.join(self.cfg.logs_root, self.cfg.experiment_name,
                                f"fixed_samples_itr{self.history['itr']}.png")
            save_image_grid(imgs.permute(0, 2, 3, 1).cpu().numpy(), path, nrow=4)
        except Exception as e:  # visualization must never kill training
            print(f"progress sheet skipped ({e})")

    # -- main loop ----------------------------------------------------------

    def run(self, steps_per_epoch: Optional[int] = None):
        cfg = self.cfg
        t = self.tcfg
        per_step_imgs = cfg.batch_size * t.num_D_steps * t.num_D_accumulations
        if steps_per_epoch is None:
            steps_per_epoch = max(len(self.dataset) // per_step_imgs, 1)
        prof = None
        try:
            for epoch in range(self.history["epoch"], cfg.num_epochs):
                if cfg.deterministic_run:
                    # Per-epoch reseed (ref trainer.py:113-119, seed + epoch + rank).
                    self.dataset.rng = np.random.default_rng(
                        cfg.seed + epoch + 100003 * self.rank)
                t0 = time.time()
                for _ in range(steps_per_epoch):
                    itr = self.history["itr"]
                    if cfg.profile_dir and itr == cfg.profile_start:
                        prof = start_profile(self.device)
                    batch = self.make_batch()
                    with (torch.profiler.record_function("train_step") if prof
                          else contextlib.nullcontext()):
                        self.state, metrics = self.step_fn(
                            self.state, batch, self.step_generator(itr))
                    self.history["itr"] += 1
                    itr += 1
                    if prof is not None and itr == cfg.profile_start + 3:
                        stop_profile(prof, self.device, cfg.profile_dir)
                        prof = None
                    if itr % max(cfg.log_every, 1) == 0:
                        vals = {k: float(v) for k, v in metrics.items()}
                        self.train_log.log(itr=itr, **vals)
                        if self.tb:
                            self.tb.add_scalars({f"Loss/{k}": v for k, v in vals.items()}, itr)
                    sv_int = self._sv_interval()
                    if sv_int > 0 and itr % sv_int == 0:
                        self.train_log.log(itr=itr, **self._sv_metrics(self._sv_nets()))
                # The epoch's time ends when its last step has run on the device.
                vals = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                imgs_per_sec = steps_per_epoch * per_step_imgs / dt
                self.epoch_stats.append(dict(epoch=epoch, seconds=dt, img_per_s=imgs_per_sec))
                print(f"epoch {epoch}: {dt:.1f}s ({imgs_per_sec:.1f} img/s) "
                      + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
                self.history["epoch"] = epoch + 1

                if (epoch + 1) % cfg.save_every == 0:
                    self.save()
                    if cfg.num_save_copies > 0:
                        self.save(suffix=f"copy{self.history['save_num']}")
                        self.history["save_num"] = (
                            self.history["save_num"] + 1) % cfg.num_save_copies
                    self._save_progress_sheet()
                if (epoch + 1) % cfg.test_every == 0:
                    m = self.test()
                    if m is not None:
                        # Divergence stop (ref trainer.py:514-516).
                        if (cfg.stop_when_diverge
                                and 2 * m.get("IS_mean", np.inf) < self.history["best_IS"]):
                            print("Divergence detected — stopping.")
                            return
                        # Early stop on patience (ref trainer.py:532-540).
                        if self.history["epochs_no_improvement"] >= cfg.es_patience:
                            print("Early stopping — no improvement.")
                            return
        finally:
            if prof is not None:
                stop_profile(prof, self.device, cfg.profile_dir)

