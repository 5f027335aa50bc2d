"""Driver ``sg2_train``: the port's StyleGAN2-ADA train step
(``train/stylegan2_step.py``) back to back in ``SG2Trainer.run``'s schedule:
the main step every step, path length every ``G_reg_interval``-th, R1 every
``D_reg_interval``-th, ``ada_update`` after every ``ada_interval``-th, each
step's generator reseeded from the run's seed and the step; no synchronize
per step.  The ADA pipe is 'bgc' on the fast geometry (the row-shift
kernel), from the configuration's ``augment`` and starting at ``p``.

The traffic file gives ``microbatch``, ``pool_images``, ``bank_rows`` (as
``biggan_train``), ``log_every`` and ``trace_steps`` (the profiled
sub-window: whole schedule periods).

``correct``: as ``biggan_train``, over the first ``REF_STEPS`` steps, one
of each variant the schedule runs: step 0 runs path length and R1, steps 1
to 3 the main step alone, then ``ada_update`` moves p, and step 4 runs path
length alone.  Compared: the losses and both penalties, the first
gradients, the change of every leaf, ``pl_mean``, the ADA sign sum that
the update read, and p after it (in steps of the controller), against the plain reference in float32
(TF32 off), from the same weights, batches and generator seeds.
"""

from __future__ import annotations

import contextlib
import time

import torch

import reference as ref
import traincheck as tc
from feed import Feed
from tracing import profiled, sync
from weights import make_state, materialize, shapes_of, sub_seed

G_SEED, D_SEED, POOL_SEED, COND_SEED, STEP_SEED = 20, 21, 22, 23, 24
LOSSES = ("G_loss", "D_loss", "pl_penalty", "r1_penalty")
# ``ada_sign_sum``: the sum the first ``ada_update`` read; ``ada_p_steps``: p
# after it, in steps of the controller (``ada_step``).
SCALARS = ("pl_mean", "ada_sign_sum", "ada_p_steps")
# Steps followed by the reference: through the first ``ada_update`` (after
# step 3 at ``ada_interval`` 4) and the first path-length-only step (4).
REF_STEPS = 5


def make_feed(ctx) -> Feed:
    m, mix = ctx["cfg"]["model"], ctx["mix"]
    return Feed(ctx["seed"], POOL_SEED, COND_SEED, images=mix["pool_images"],
                channels=m["img_channels"], resolution=m["img_resolution"],
                feat_dim=m["h_dim"], bank_rows=mix["bank_rows"],
                microbatch=mix["microbatch"], gen_shape=mix["microbatch"])


def batch_of(feed: Feed, step: int, device, reference: bool = False) -> dict:
    real, gen = feed.rows(step)
    x = (feed.reference_images if reference else feed.images)(real, device)
    return dict(x=x, h=feed.features(real, device), gen_h=feed.features(gen, device))


def _states(ctx, device):
    """G's and D's seeded states, keyed by the reference's models
    (``weights.py``)."""
    from reference.icgan_ref.models import stylegan2 as sg2

    init, seed = ctx["cfg"]["init"], ctx["seed"]
    mcfg = sg2.StyleGAN2Config(**ctx["cfg"]["model"])
    return (make_state(shapes_of(sg2.Generator(mcfg, device="meta")), init,
                       sub_seed(seed, G_SEED), device),
            make_state(shapes_of(sg2.Discriminator(mcfg, device="meta")), init,
                       sub_seed(seed, D_SEED), device))


class Trainer:
    """The program's (or, with ``frozen``, the reference's) state, its four
    step variants and the schedule."""

    def __init__(self, ctx, device, frozen: bool):
        if frozen:
            from reference.icgan_ref.data.ada import AugmentPipe
            from reference.icgan_ref.models import stylegan2 as sg2
            from reference.icgan_ref.train import stylegan2_step as st
        else:
            from ic_gan_tpu_torch.data.ada import AugmentPipe
            from ic_gan_tpu_torch.models import stylegan2 as sg2
            from ic_gan_tpu_torch.train import stylegan2_step as st
        cfg = ctx["cfg"]
        model = dict(cfg["model"], num_fp16_res=0) if frozen else cfg["model"]
        mcfg = sg2.StyleGAN2Config(**model)
        g, d = sg2.Generator(mcfg, device="meta"), sg2.Discriminator(mcfg, device="meta")
        gs, ds = _states(ctx, device)
        init, seed = cfg["init"], ctx["seed"]
        g = materialize(g, gs, device, init, sub_seed(seed, G_SEED))
        d = materialize(d, ds, device, init, sub_seed(seed, D_SEED))
        del gs, ds
        self.tcfg = st.SG2TrainConfig(**cfg["train"]["SG2TrainConfig"])
        self.state = st.SG2TrainState.create(g, d, self.tcfg)
        self.state.ada_p = torch.full((), float(cfg["train"]["augment_p"]), device=device)
        pipe = AugmentPipe.from_spec(cfg["train"]["augment"], geom_impl="fast")
        self.steps = {(pl, r1): st.make_sg2_train_step(self.tcfg, mcfg.z_dim, do_pl=pl,
                                                       do_r1=r1, augment_fn=pipe)
                      for pl in (False, True) for r1 in (False, True)}
        self.ada_update = st.ada_update
        self.gen = torch.Generator(device=device)
        self.base = sub_seed(ctx["seed"], STEP_SEED)
        self.mb = ctx["mix"]["microbatch"]
        self.adapted_sign_sum = None   # the sign sum the last ada_update read

    def variant(self, i: int) -> tuple:
        t = self.tcfg
        return (i % t.G_reg_interval == 0 and t.pl_weight != 0,
                i % t.D_reg_interval == 0 and t.r1_gamma != 0)

    def step(self, i: int, batch: dict) -> dict:
        self.gen.manual_seed(tc.step_seed(self.base, i))
        self.state, metrics = self.steps[self.variant(i)](self.state, batch, self.gen)
        if (i + 1) % self.tcfg.ada_interval == 0:
            self.adapted_sign_sum = self.state.ada_sign_sum
            self.state = self.ada_update(self.state, self.tcfg, self.mb)
        return metrics


def follow(ctx, device, tr: Trainer, batch_of) -> dict:
    rec = dict(losses=[])
    s = tr.state
    for i in range(REF_STEPS):
        metrics = tr.step(i, batch_of(i))
        rec["losses"].append(tc.record_losses(metrics, LOSSES))
        if i == 0:
            rec["grads"] = tc.first_grads({"G": (s.g, s.g_opt), "D": (s.d, s.d_opt)})
    gs, ds = _states(ctx, device)
    start = {f"{t}.{k}": v for t, st in (("G", gs), ("E", gs), ("D", ds)) for k, v in st.items()}
    rec["change"] = tc.changes({"G": s.g, "D": s.d, "E": s.g_ema}, start)
    rec["scalars"] = dict(pl_mean=float(s.pl_mean), ada_p_steps=float(s.ada_p) / ada_step(tr),
                          ada_sign_sum=float(tr.adapted_sign_sum))
    return rec


def ada_step(tr: Trainer) -> float:
    """How far one ``ada_update`` moves p (ADA's ``batch · interval /
    (ada_kimg · 1000)``)."""
    return tr.mb * tr.tcfg.ada_interval / (tr.tcfg.ada_kimg * 1000.0)


def reference_record(ctx, device, feed, control: bool = False) -> dict:
    lowp = ref.fp8_operands() if control else contextlib.nullcontext()
    with ref.float32_exact(), lowp:
        tr = Trainer(ctx, device, frozen=True)
        return follow(ctx, device, tr, lambda i: batch_of(feed, i, device, True))


class KernelBytes:
    """Inside the block, the bytes that the row-shift and bias-activation
    kernel entry points of the port (``ops/row_shift.py``,
    ``ops/bias_act.py``) are asked to move, each input byte read once and
    each output byte written once, worked out from their arguments: shapes
    and types and, for the row shift, the offsets that bound each row's
    in-frame window (kept, and read once the block has ended).  An entry
    point the port no longer has records nothing."""

    def __init__(self):
        self.fixed, self.shifts = [], []

    def _bias_act(self, x, b, n_tensors):
        if x.numel():
            self.fixed.append(x.element_size() * n_tensors * x.numel()
                              + (0 if b is None else b.element_size() * b.numel()))

    def _row_shift(self, x, off, l_out=None, *rest, **kw):
        l_out = kw.get("l_out", l_out)
        self.shifts.append((off, x.shape[1], x.shape[1] if l_out is None else int(l_out),
                            x.element_size()))

    @contextlib.contextmanager
    def recording(self):
        import ic_gan_tpu_torch.ops.bias_act as ba
        import ic_gan_tpu_torch.ops.row_shift as rs

        saved = []

        def wrap(mod, name, note):
            fn = getattr(mod, name, None)
            if fn is None:
                return

            def recorded(*args, **kw):
                note(*args, **kw)
                return fn(*args, **kw)

            # The entry point counts its launches on the name it is called by.
            recorded.__dict__.update(fn.__dict__)
            saved.append((mod, name, fn))
            setattr(mod, name, recorded)

        wrap(ba, "bias_act_fwd", lambda x, b=None, *a, **kw: self._bias_act(x, b, 2))
        wrap(ba, "bias_act_bwd", lambda gy, x, b=None, *a, **kw: self._bias_act(x, b, 3))
        wrap(rs, "row_shift_fwd", self._row_shift)
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def bytes(self) -> list:
        out = list(self.fixed)
        for off, length, l_out, item in self.shifts:
            k = torch.floor(off.float()).to(torch.int64)
            n_in = int(((k + l_out + 1).clamp(max=length) - k.clamp(min=0)).clamp(min=0).sum())
            out.append(item * (n_in + off.numel() * l_out) + 4 * off.numel())
        return out


def run(ctx):
    device, mix = ctx["device"], ctx["mix"]
    feed = make_feed(ctx)
    tr = Trainer(ctx, device, frozen=False)
    prog = follow(ctx, device, tr, lambda i: batch_of(feed, i, device))
    sync(device)
    setup_s = ctx["process_age"]()

    def steps(first, stop):
        i = first
        while not stop(i):
            metrics = tr.step(i, batch_of(feed, i, device))
            i += 1
            if i % mix["log_every"] == 0:
                {k: float(v) for k, v in metrics.items()}
        sync(device)
        return i

    first = REF_STEPS
    t0 = time.perf_counter()
    end = steps(first, lambda i: time.perf_counter() - t0 >= ctx["seconds"])
    window_s = time.perf_counter() - t0
    n = end - first
    obs = dict(kind="train", setup_s=setup_s, window_s=window_s,
               images=n * mix["microbatch"] * ctx["chips"], chips=ctx["chips"])
    if ctx["trace"]:
        w, mb = ctx["work"], mix["microbatch"]
        flops = sum(w.step_flops(ctx["cfg"], mb, *tr.variant(i)) for i in range(first, end))
        obs["rate"] = dict(seconds=window_s, flops=flops, peak=w.PEAK_FLOPS["bfloat16"])
        kb = KernelBytes()
        with kb.recording(), profiled(lambda: sync(device)) as prof:
            steps(end, lambda i: i >= end + mix["trace_steps"])
        t = prof["trace"]
        t.calls = mix["trace_steps"]
        t.extra["kernel_bytes"] = kb.bytes()
        obs["trace"] = t
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    obs["peak_bytes"] = peak
    del tr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = tc.compare(prog, reference_record(ctx, device, feed), ctx["limits"], SCALARS)
    return dict(obs=obs, attempted=n, failed=0, memory_peak_bytes=peak, checks=checks,
                correct=all(c["ok"] for c in checks), reference_s=time.perf_counter() - t_ref)


def control(ctx) -> list:
    """The control: the reference on float8 operands, judged as the program
    is."""
    device = ctx["device"]
    feed = make_feed(ctx)
    low = reference_record(ctx, device, feed, control=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return tc.compare(low, reference_record(ctx, device, feed), ctx["limits"], SCALARS)
