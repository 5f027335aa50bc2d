"""Driver ``sample``: requests of fixed size from one client in a closed loop
through the port's deployment sampler (``io/deploy.py:make_sampler``, σ
folded, bf16 weights), each timed from its call until its images are ready
on the device.

The traffic file gives ``batch`` (the sampler's batch), ``request_rows``,
``pool_requests`` (the seeded pool of requests the client cycles through),
``bank_rows`` (the instance-feature bank: unit-norm rows), ``keep_candidates``
(how many of the pool's requests are drawn from the seed to be kept for the
check), ``control_requests``, ``warmup_calls``, ``trace_calls`` (the profiled sub-window) and
``reference_block`` (rows a reference forward takes at once).

``correct``: after the window, the kept requests that the window finished,
and its last request, are computed again by the plain reference in float32
(TF32 off) from the same inputs and the same weights as the configuration
serves them (σ folded, then rounded to bf16).  Compared: mean |Δ| over mean
|reference| over all those images, and the worst single image's mean |Δ|
over the same mean |reference|.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import reference as ref
from tracing import profiled, sync
from weights import make_state, materialize, shapes_of, sub_seed

W_SEED, IN_SEED, KEEP_SEED = 0, 1, 2


def model_cfg(cfg: dict, dtype, frozen: bool = False):
    if frozen:
        from reference.icgan_ref.models.biggan import BigGANConfig
    else:
        from ic_gan_tpu_torch.models.biggan import BigGANConfig
    return BigGANConfig(**cfg["model"], dtype=dtype)


def weights(ctx, device) -> dict:
    """G's seeded state, keyed by the reference's G (``weights.py``)."""
    from reference.icgan_ref.models.biggan import Generator

    g = Generator(model_cfg(ctx["cfg"], torch.float32, frozen=True), device="meta")
    return make_state(shapes_of(g), ctx["cfg"]["init"], w_seed(ctx), device)


def w_seed(ctx) -> int:
    return sub_seed(ctx["seed"], W_SEED)


def make_requests(ctx, device):
    """The pool: z (P, rows, dim_z) and instance features (P, rows, F) from
    the bank, on the device, from the seed."""
    mix, c = ctx["mix"], model_cfg(ctx["cfg"], torch.float32, frozen=True)
    gen = torch.Generator(device=device).manual_seed(sub_seed(ctx["seed"], IN_SEED))
    p, rows = mix["pool_requests"], mix["request_rows"]
    bank = torch.randn((mix["bank_rows"], c.instance_sz), generator=gen, device=device)
    bank /= bank.norm(dim=1, keepdim=True)
    z = torch.randn((p, rows, c.effective_dim_z), generator=gen, device=device)
    idx = torch.randint(0, mix["bank_rows"], (p, rows), generator=gen, device=device)
    return z, bank[idx]


def build_sampler(ctx, device, int8_calibration=None):
    """The program's sampler over the folded G, its weights and compute in
    the configuration's types (``cfg["sample"]``); with
    ``int8_calibration`` (z, feats) its int8 serving path instead
    (``io/quant.py``, calibrated in float32 on those inputs)."""
    from ic_gan_tpu_torch.io.deploy import (
        cast_params,
        fold_spectral_norm,
        make_sampler,
        set_compute_dtype,
    )
    from ic_gan_tpu_torch.models.biggan import Generator

    int8 = int8_calibration is not None
    served = ctx["cfg"]["sample"]
    compute, weights_dtype = getattr(torch, served["compute"]), getattr(torch, served["weights"])
    g = Generator(model_cfg(ctx["cfg"], torch.float32 if int8 else compute), device="meta")
    g = materialize(g, weights(ctx, device), device, ctx["cfg"]["init"], w_seed(ctx)).eval()
    if int8:
        from ic_gan_tpu_torch.io.quant import quantize_variables

        z, feats = int8_calibration
        with torch.inference_mode():
            quantize_variables(g, z, None, feats)
        set_compute_dtype(g, compute)
    fold_spectral_norm(g)
    cast_params(g, weights_dtype)
    return make_sampler(g, batch_size=ctx["mix"]["batch"], device=device)


def reference_images(ctx, device, inputs) -> list:
    """The plain reference's NHWC float32 images for each (z, feats): its own
    eval-mode σ folded into the weights, the weights then rounded to the type
    the configuration serves them in (``cfg["sample"]["weights"]``), and
    every operation in float32."""
    from reference.icgan_ref.models.biggan import Generator
    from reference.icgan_ref.models.layers import _SpectralNormed

    block = ctx["mix"]["reference_block"]
    served = getattr(torch, ctx["cfg"]["sample"]["weights"])
    with ref.float32_exact(), torch.inference_mode():
        g = Generator(model_cfg(ctx["cfg"], torch.float32, frozen=True), device="meta")
        g = materialize(g, weights(ctx, device), device).eval()
        for m in g.modules():
            if isinstance(m, _SpectralNormed):
                m.fold_()
        for p in g.parameters():
            p.data = p.data.to(served).float()
        out = []
        for z, feats in inputs:
            out.append(torch.cat([g(z[i:i + block], None, feats[i:i + block])
                                  for i in range(0, z.shape[0], block)]).permute(0, 2, 3, 1))
    return out


def judge(ctx, device, kept: dict, pool) -> list:
    z, feats = pool
    p = z.shape[0]
    order = sorted(kept)
    refs = reference_images(ctx, device, [(z[i % p], feats[i % p]) for i in order])
    gaps = ref.image_gaps((kept[i], r) for i, r in zip(order, refs))
    return ref.checks_of({f"img_err_{k}": v for k, v in gaps.items()}, ctx["limits"])


def closed_loop(sampler, pool, seconds, device, keep=(), first=0, calls=None):
    """Requests ``first, first + 1, ...`` until ``seconds`` have passed (or
    ``calls`` requests): latencies, the kept outputs, the last request's
    index and the window's length."""
    z, feats = pool
    p = z.shape[0]
    lat, kept, i = [], {}, first
    sync(device)
    start = time.perf_counter()
    while True:
        zi, fi = z[i % p], feats[i % p]
        t0 = time.perf_counter()
        imgs = sampler(zi, feats=fi, device_output=True)
        sync(device)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if i in keep:
            kept[i] = imgs
        i += 1
        if (calls is not None and i - first >= calls) or (calls is None and t1 - start >= seconds):
            kept[i - 1] = imgs
            return lat, kept, t1 - start


def run(ctx):
    device, mix, seed = ctx["device"], ctx["mix"], ctx["seed"]
    pool = make_requests(ctx, device)
    sampler = build_sampler(ctx, device)
    for i in range(mix["warmup_calls"]):
        sampler(pool[0][i], feats=pool[1][i], device_output=True)
    sync(device)
    rng = np.random.default_rng(sub_seed(seed, KEEP_SEED))
    keep = set(rng.choice(mix["pool_requests"], mix["keep_candidates"], replace=False).tolist())
    setup_s = ctx["process_age"]()

    lat, kept, window_s = closed_loop(sampler, pool, ctx["seconds"], device, keep)
    n = len(lat)
    obs = dict(kind="sample", setup_s=setup_s, window_s=window_s, latencies=lat,
               images=n * mix["request_rows"], chips=ctx["chips"])
    if ctx["trace"]:
        flops = ctx["work"].generator_flops_per_image(ctx["cfg"])
        obs["rate"] = dict(seconds=window_s, flops=obs["images"] * flops,
                           peak=ctx["work"].PEAK_FLOPS["bfloat16"])
        with profiled(lambda: sync(device)) as prof:
            closed_loop(sampler, pool, None, device, first=n, calls=mix["trace_calls"])
        tr = prof["trace"]
        tr.calls = mix["trace_calls"]
        batches = -(-mix["request_rows"] // mix["batch"]) * tr.calls
        w = ctx["work"]
        tr.extra["attention"] = [(k, s, *w.attention_cost(k, s))
                                 for k, s in w.sample_attention_calls(ctx["cfg"], mix["batch"])
                                 ] * batches
        obs["trace"] = tr
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    obs["peak_bytes"] = peak
    del sampler
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = judge(ctx, device, kept, pool)
    return dict(obs=obs, attempted=n, failed=0, memory_peak_bytes=peak, checks=checks,
                correct=all(c["ok"] for c in checks), reference_s=time.perf_counter() - t_ref)


def control(ctx) -> list:
    """The control: the program's own int8 serving path (the next precision
    below the configuration's bf16), calibrated as ``quantize_serving`` does
    on 64 rows, over the pool's first ``control_requests`` requests, judged
    as the window's requests are."""
    device, mix = ctx["device"], ctx["mix"]
    pool = make_requests(ctx, device)
    z, feats = pool
    sampler = build_sampler(ctx, device, int8_calibration=(z[0][:64], feats[0][:64]))
    kept = {i: sampler(z[i], feats=feats[i], device_output=True)
            for i in range(mix["control_requests"])}
    del sampler
    return judge(ctx, device, kept, pool)
