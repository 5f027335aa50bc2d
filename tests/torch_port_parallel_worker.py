"""One rank of ``test_torch_port_parallel.py``'s two-process gloo launch.

    python tests/torch_port_parallel_worker.py RANK WORLD INIT_METHOD OUT_DIR

Runs, on the CPU and without JAX, the three legs of
``__graft_entry__.dryrun_multichip`` in float64 (BigGAN and BigGAN-deep at
32² ch 8 with two accumulations; StyleGAN2 at 8² with ``mbstd_group_size``
2, R1, path length and DiffAugment colour) plus a StyleGAN2 step with the
ADA pipe, each once data-parallel over the process group and once on one
rank over the global batch; then the sharded Inception evaluator and
sampler, the collector, a one-step ``Trainer.run``, the mesh's clamp and
``replicated``.  Writes ``OUT_DIR/rank{RANK}.pt`` for the test to compare.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.data.augment import diff_augment
from ic_gan_tpu_torch.data.datasets import Batch
from ic_gan_tpu_torch.eval.pipeline import InceptionEvaluator
from ic_gan_tpu_torch.io.deploy import make_sampler
from ic_gan_tpu_torch.models import stylegan2 as sg2
from ic_gan_tpu_torch.models.biggan import BigGANConfig
from ic_gan_tpu_torch.models.biggan_deep import BigGANDeepConfig, model_classes
from ic_gan_tpu_torch.parallel import stats
from ic_gan_tpu_torch.parallel.mesh import (
    distributed_init,
    local_batch_size,
    make_mesh,
    replicated,
    shard_batch,
)
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
from ic_gan_tpu_torch.train.stylegan2_step import (
    SG2TrainConfig,
    SG2TrainState,
    make_sg2_train_step,
)
from ic_gan_tpu_torch.train.trainer import Trainer, TrainerConfig

F64 = torch.float64
BIGGAN = dict(resolution=32, n_classes=10, G_ch=8, D_ch=8, dim_z=20, G_attn="0", D_attn="0",
              shared_dim=16, shared_dim_feat=24, instance_sz=32)
DEEP = dict(resolution=32, n_classes=10, G_ch=8, D_ch=8, dim_z=16, G_depth=1, D_depth=1,
            G_attn="0", D_attn="0", shared_dim_feat=24, instance_sz=32, class_cond=False,
            instance_cond=True)
SG2 = dict(img_resolution=8, z_dim=8, c_dim=0, h_dim=12, w_dim=16, channel_base=512,
           channel_max=32, num_fp16_res=0, conv_clamp=None, num_mapping_layers=2,
           mbstd_group_size=2)


def _numpy(metrics):
    return {k: ({n: g.numpy() for n, g in v.items()} if isinstance(v, dict)
                else float(v)) for k, v in metrics.items()}


def _state(*nets):
    return [{k: v.detach().clone() for k, v in net.state_dict().items()} for net in nets]


def biggan_leg(mesh, deep: bool):
    """The BigGAN (or deep) step, data-parallel and on one rank; the BigGAN
    leg adds DiffAugment and both orthogonal terms, so that the augment
    draws of the D phase's [fake, real] stack and the ortho-once order are
    held too."""
    cfg = BigGANDeepConfig(**DEEP, dtype=F64) if deep else BigGANConfig(**BIGGAN, dtype=F64)
    tcfg = TrainConfig(num_D_steps=1, num_D_accumulations=2, num_G_accumulations=2,
                       ema_start=0, **({} if deep else dict(
                           DiffAugment="color,translation,cutout", G_ortho=1e-4,
                           D_ortho=1e-4)))
    g_cls, d_cls = model_classes(cfg)
    init = torch.Generator().manual_seed(7 if deep else 0)
    g0 = g_cls(cfg, device="cpu", generator=init).double()
    d0 = d_cls(cfg, device="cpu", generator=init).double()
    nD, mb = 2, 2 * mesh.world
    rng = np.random.default_rng(9 if deep else 2)
    batch = dict(x=rng.standard_normal((nD, mb, 3, 32, 32)) * 0.5,
                 feats=rng.standard_normal((nD, mb, cfg.instance_sz)),
                 gen_feats=rng.standard_normal((nD + 2, mb, cfg.instance_sz)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, m in (("ref", None), ("dp", mesh)):
        g, d = copy.deepcopy(g0), copy.deepcopy(d0)
        state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
        step = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True, mesh=m)
        b = batch if m is None else shard_batch(m, batch, axis=1)
        _, metrics = step(state, b, torch.Generator().manual_seed(0))
        out[name] = _numpy(metrics)
        out[f"{name}_state"] = _state(g, d, state.g_ema)
    return out


def sg2_leg(mesh, ada: bool):
    """The StyleGAN2 step: the reg variant (R1 and path length) with
    DiffAugment colour, or with ``ada`` the main step with the 'bgc' pipe."""
    cfg = sg2.StyleGAN2Config(**SG2)
    init = torch.Generator().manual_seed(3)
    g0 = sg2.Generator(cfg, device="cpu", generator=init).double()
    d0 = sg2.Discriminator(cfg, device="cpu", generator=init).double()
    tcfg = SG2TrainConfig()
    if ada:
        pipe = AugmentPipe.from_spec("bgc")
        augment = lambda img, p, gen: pipe(img, p, gen)  # noqa: E731
    else:
        augment = lambda img, p, gen: diff_augment(img, "color", gen)  # noqa: E731
    n = 2 * mesh.world
    rng = np.random.default_rng(5)
    batch = dict(x=rng.standard_normal((n, 3, 8, 8)) * 0.5,
                 h=rng.standard_normal((n, cfg.h_dim)),
                 gen_h=rng.standard_normal((n, cfg.h_dim)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, m in (("ref", None), ("dp", mesh)):
        g, d = copy.deepcopy(g0), copy.deepcopy(d0)
        state = SG2TrainState.create(g, d, tcfg)
        if ada:
            state.ada_p = torch.tensor(0.6, dtype=F64)
        step = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=not ada, do_r1=not ada,
                                   augment_fn=augment, debug_grads=True, mesh=m)
        b = batch if m is None else shard_batch(m, batch)
        state, metrics = step(state, b, torch.Generator().manual_seed(6))
        out[name] = _numpy(metrics)
        out[name]["pl_mean"] = float(state.pl_mean)
        out[name]["ada_sign_sum"] = float(state.ada_sign_sum)
        out[f"{name}_state"] = _state(g, d, state.g_ema)
    return out


def eval_and_sampler(mesh):
    """Three images through the sharded evaluator (a tail that pads), and
    five through a sampler of batch 4 (two batches), against one rank."""
    x = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1, (3, 3, 32, 32))
                         .astype(np.float32))
    ev = InceptionEvaluator(mesh=mesh, device="cpu")
    pool, logits = ev(x)
    out = dict(pool=pool, logits=logits)
    if mesh.rank == 0:
        out["ref_pool"], out["ref_logits"] = InceptionEvaluator(device="cpu")(x)
    cfg = BigGANConfig(**BIGGAN, dtype=F64)
    g_cls, _ = model_classes(cfg)
    g = g_cls(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).double()
    rng = np.random.default_rng(12)
    z = torch.from_numpy(rng.standard_normal((5, cfg.effective_dim_z)))
    feats = torch.from_numpy(rng.standard_normal((5, cfg.instance_sz)))
    out["images"] = make_sampler(copy.deepcopy(g), batch_size=4, device="cpu",
                                 mesh=mesh)(z, feats=feats)
    out["ref_images"] = make_sampler(copy.deepcopy(g), batch_size=4, device="cpu")(z, feats=feats)
    return out


class MemoryData:
    """Images, features and labels from a seed behind the dataset surface
    ``Trainer`` reads."""

    which_nn_balance = "instance_balance"

    def __init__(self, n=16, seed=4):
        gen = torch.Generator().manual_seed(seed)
        self.images = torch.rand((n, 3, 32, 32), generator=gen) * 2 - 1
        self.feats = F.normalize(torch.randn((n, BIGGAN["instance_sz"]), generator=gen), dim=1)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.images)

    def sample_batch(self, k, weights=None):
        i = self.rng.integers(0, len(self), k)
        return Batch(self.images[i], None, self.feats[i].numpy(), None)

    def sample_conditioning_instance_balance(self, k, weights=None):
        return None, self.feats[self.rng.integers(0, len(self), k)].numpy()


def trainer_run(mesh, out_dir):
    root = os.path.join(out_dir, f"trainer_rank{mesh.rank}")
    cfg = TrainerConfig(experiment_name="dp", weights_root=os.path.join(root, "w"),
                        logs_root=os.path.join(root, "l"), num_epochs=1, test_every=1,
                        batch_size=4, seed=3, enable_tb=False, log_every=1)
    tr = Trainer(BigGANConfig(**BIGGAN), TrainConfig(ema_start=0), cfg, MemoryData(),
                 device="cpu")
    tr.run(steps_per_epoch=1)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return dict(files=files, state=_state(tr.state.g, tr.state.d, tr.state.g_ema),
                itr=tr.history["itr"])


def trainer_stop(mesh, out_dir):
    """``Trainer.run`` with an eval that would score each rank differently
    (rank 0: IS 1 then 0.5, an early stop at patience 1; any other rank:
    IS rising): the ranks must stop at the same step, rank 0's, and only
    rank 0 evaluates."""
    root = os.path.join(out_dir, f"trainer_stop_rank{mesh.rank}")
    cfg = TrainerConfig(experiment_name="dpstop", weights_root=os.path.join(root, "w"),
                        logs_root=os.path.join(root, "l"), num_epochs=4, test_every=1,
                        batch_size=4, seed=5, enable_tb=False, es_patience=1,
                        which_best="IS", num_save_copies=0)
    scores = [1.0, 0.5, 0.25, 0.125] if mesh.rank == 0 else [1.0, 2.0, 3.0, 4.0]
    calls = []

    def eval_fn(trainer):
        calls.append(trainer.history["itr"])
        return {"IS_mean": scores[len(calls) - 1], "FID": 10.0 * len(calls)}

    tr = Trainer(BigGANConfig(**BIGGAN), TrainConfig(ema_start=0), cfg, MemoryData(),
                 eval_fn=eval_fn, device="cpu")
    tr.run(steps_per_epoch=1)
    h = tr.history
    return dict(itr=h["itr"], eval_calls=calls, best_IS=h["best_IS"],
                no_improvement=h["epochs_no_improvement"],
                state=_state(tr.state.g, tr.state.d, tr.state.g_ema))


def main(rank: int, world: int, init_method: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    distributed_init(num_processes=world, process_id=rank, init_method=init_method,
                     device="cpu", timeout_s=120)
    assert distributed_init() is True     # a second call is a no-op
    mesh = make_mesh(device="cpu")
    res = dict(world=mesh.world, rank=mesh.rank)
    res["biggan"] = biggan_leg(mesh, deep=False)
    res["deep"] = biggan_leg(mesh, deep=True)
    res["sg2"] = sg2_leg(mesh, ada=False)
    res["sg2_ada"] = sg2_leg(mesh, ada=True)
    res["eval"] = eval_and_sampler(mesh)
    col = stats.Collector("loss.*")
    s = stats.report({}, "loss/a", torch.arange(3.0) + 10 * rank)
    col.update(stats.report(s, "other", torch.ones(2)))
    res["collector"] = col.as_dict()
    res["trainer"] = trainer_run(mesh, out_dir)
    res["trainer_stop"] = trainer_stop(mesh, out_dir)
    clamped = make_mesh(batch_size=3, device="cpu")
    res["clamped"] = (clamped.world, clamped.rank)
    res["local_batch"] = local_batch_size(6)
    try:
        local_batch_size(5)
        res["local_batch_5"] = "no error"
    except ValueError as e:
        res["local_batch_5"] = str(e)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank))
    probe = torch.full((2,), float(rank + 1))
    replicated(mesh, lin, probe)
    res["replicated"] = (lin.weight.sum().item(), probe.tolist())
    res["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "ic_gan_tpu."))
                              for m in sys.modules)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
