"""Driver ``biggan_train``: the port's BigGAN/IC-GAN train step
(``train/step.py:make_train_step``) back to back, as ``Trainer.run``
dispatches it: no synchronize per step, each step's generator reseeded from
the run's seed and the step, the losses read every ``log_every`` steps.

The traffic file gives ``microbatch``, ``pool_images`` (the
seeded pool of uint8 images on the host; each goes through
``data/loader.py:normalize_batch``, and its instance feature is the bank's
row of the same index), ``bank_rows`` (unit-norm instance features on the
host, where the generator's conditionings are drawn from), ``log_every``
and ``trace_steps`` (the profiled sub-window).

``correct``: set-up drives the same state object through its first
``traincheck.REF_STEPS`` steps before the window; the plain reference
(float32, TF32 off) follows them from the same weights, batches and
generator seeds, and ``traincheck.compare`` holds the losses, the first
gradients and the change of every leaf (G, D, the EMA copy, the
spectral-norm and batch-norm state) to the cell's limits.
"""

from __future__ import annotations

import time

import torch

import reference as ref
import traincheck as tc
from feed import Feed
from tracing import profiled, sync
from weights import make_state, materialize, shapes_of, sub_seed

G_SEED, D_SEED, POOL_SEED, COND_SEED, STEP_SEED = 10, 11, 12, 13, 14
LOSSES = ("D_loss_real", "D_loss_fake", "G_loss")


def make_feed(ctx) -> Feed:
    m, mix = ctx["cfg"]["model"], ctx["mix"]
    return Feed(ctx["seed"], POOL_SEED, COND_SEED, images=mix["pool_images"], channels=3,
                resolution=m["resolution"], feat_dim=m["instance_sz"],
                bank_rows=mix["bank_rows"], microbatch=mix["microbatch"],
                gen_shape=(2, mix["microbatch"]))


def batch_of(feed: Feed, step: int, device, reference: bool = False) -> dict:
    """Step ``step``'s slab batch (one D microbatch, two generator
    conditionings), through the port's loader, or for the reference by the
    loader's formula."""
    real, gen = feed.rows(step)
    x = (feed.reference_images if reference else feed.images)(real, device)
    return dict(x=x[None], feats=feed.features(real, device)[None],
                gen_feats=feed.features(gen, device))


def _states(ctx, device):
    """G's and D's seeded states, keyed by the reference's models
    (``weights.py``)."""
    from reference.icgan_ref.models.biggan import BigGANConfig, Discriminator, Generator

    init, seed = ctx["cfg"]["init"], ctx["seed"]
    mcfg = BigGANConfig(**ctx["cfg"]["model"], dtype=torch.float32)
    return (make_state(shapes_of(Generator(mcfg, device="meta")), init,
                       sub_seed(seed, G_SEED), device),
            make_state(shapes_of(Discriminator(mcfg, device="meta")), init,
                       sub_seed(seed, D_SEED), device))


def seeded_leaves(ctx, device) -> dict:
    """Every floating leaf's seeded value, keyed as ``traincheck`` keys them
    (the EMA copy starts as G)."""
    gs, ds = _states(ctx, device)
    out = {f"G.{k}": v for k, v in gs.items() if v.is_floating_point()}
    out.update({f"E.{k}": v for k, v in gs.items() if v.is_floating_point()})
    out.update({f"D.{k}": v for k, v in ds.items() if v.is_floating_point()})
    return out


def build(ctx, device, frozen: bool, dtype):
    """(state, step): the program's or, with ``frozen``, the reference's G,
    D, optimizers and step, holding the seeded weights."""
    if frozen:
        from reference.icgan_ref.models.biggan import BigGANConfig, Discriminator, Generator
        from reference.icgan_ref.train.state import GANTrainState
        from reference.icgan_ref.train.step import TrainConfig, make_train_step
    else:
        from ic_gan_tpu_torch.models.biggan import BigGANConfig, Discriminator, Generator
        from ic_gan_tpu_torch.train.state import GANTrainState
        from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
    mcfg = BigGANConfig(**ctx["cfg"]["model"], dtype=dtype)
    g, d = Generator(mcfg, device="meta"), Discriminator(mcfg, device="meta")
    gs, ds = _states(ctx, device)
    init, seed = ctx["cfg"]["init"], ctx["seed"]
    g = materialize(g, gs, device, init, sub_seed(seed, G_SEED))
    d = materialize(d, ds, device, init, sub_seed(seed, D_SEED))
    del gs, ds
    tcfg = TrainConfig(**ctx["cfg"]["train"]["TrainConfig"])
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    return state, make_train_step(tcfg, mcfg.effective_dim_z)


def follow(ctx, device, state, step, batch_of, generator) -> dict:
    """Drive ``state`` through the first ``REF_STEPS`` steps and record what
    ``traincheck.compare`` compares."""
    rec = dict(losses=[], scalars={})
    for i in range(tc.REF_STEPS):
        generator.manual_seed(tc.step_seed(sub_seed(ctx["seed"], STEP_SEED), i))
        state, metrics = step(state, batch_of(i), generator)
        rec["losses"].append(tc.record_losses(metrics, LOSSES))
        if i == 0:
            rec["grads"] = tc.first_grads({"G": (state.g, state.g_opt),
                                           "D": (state.d, state.d_opt)})
    start = seeded_leaves(ctx, device)
    rec["change"] = tc.changes({"G": state.g, "D": state.d, "E": state.g_ema}, start)
    return rec


def reference_record(ctx, device, feed, control: bool = False) -> dict:
    """The plain reference (float32, TF32 off; with ``control`` its matrix
    products on float8 operands) through the same first steps."""
    import contextlib

    lowp = ref.fp8_operands() if control else contextlib.nullcontext()
    with ref.float32_exact(), lowp:
        state, step = build(ctx, device, True, torch.float32)
        gen = torch.Generator(device=device)
        rec = follow(ctx, device, state, step, lambda i: batch_of(feed, i, device, True), gen)
    return rec


def run(ctx):
    device, mix, seed = ctx["device"], ctx["mix"], ctx["seed"]
    feed = make_feed(ctx)
    state, step = build(ctx, device, False, getattr(torch, ctx["cfg"]["train"]["compute"]))
    gen = torch.Generator(device=device)
    prog = follow(ctx, device, state, step, lambda i: batch_of(feed, i, device), gen)
    sync(device)
    setup_s = ctx["process_age"]()

    step_base = sub_seed(seed, STEP_SEED)

    def steps(first, stop):
        i = first
        while not stop(i):
            gen.manual_seed(tc.step_seed(step_base, i))
            _, metrics = step(state, batch_of(feed, i, device), gen)
            i += 1
            if i % mix["log_every"] == 0:
                {k: float(v) for k, v in metrics.items()}
        sync(device)
        return i

    first = tc.REF_STEPS
    t0 = time.perf_counter()
    end = steps(first, lambda i: time.perf_counter() - t0 >= ctx["seconds"])
    window_s = time.perf_counter() - t0
    n = end - first
    obs = dict(kind="train", setup_s=setup_s, window_s=window_s,
               images=n * mix["microbatch"] * ctx["chips"], chips=ctx["chips"])
    if ctx["trace"]:
        w = ctx["work"]
        obs["rate"] = dict(seconds=window_s, flops=n * w.train_flops_per_step(ctx["cfg"],
                                                                              mix["microbatch"]),
                           peak=w.PEAK_FLOPS["bfloat16"])
        with profiled(lambda: sync(device)) as prof:
            steps(end, lambda i: i >= end + mix["trace_steps"])
        tr = prof["trace"]
        tr.calls = mix["trace_steps"]
        tr.extra["attention"] = [(k, s, *w.attention_cost(k, s)) for k, s in
                                 w.train_attention_calls(ctx["cfg"], mix["microbatch"])
                                 ] * tr.calls
        obs["trace"] = tr
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    obs["peak_bytes"] = peak
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = tc.compare(prog, reference_record(ctx, device, feed), ctx["limits"])
    return dict(obs=obs, attempted=n, failed=0, memory_peak_bytes=peak, checks=checks,
                correct=all(c["ok"] for c in checks), reference_s=time.perf_counter() - t_ref)


def control(ctx) -> list:
    """The control: the reference on float8 operands, the next precision
    below the configuration's bf16 compute, judged as the program is."""
    device = ctx["device"]
    feed = make_feed(ctx)
    low = reference_record(ctx, device, feed, control=True)
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return tc.compare(low, reference_record(ctx, device, feed), ctx["limits"])
