#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of IC-GAN on one GPU and check it.

    python3 chip_smoke.py              # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile    # adds a device-time breakdown of one batch

Phases, run in order; any failure ends the run with a non-zero exit:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build every kernel under ``ic_gan_tpu_torch/csrc`` with nvcc, in parallel,
   into ``ic_gan_tpu_torch/build/``;
3. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and a few others, with the tolerance stated beside each;
4. kernel timings at the main shape: the kernel, its plain version, one
   library call computing the same function (a yardstick the port never
   calls), and the least time the card could take;
5. the main path: the 256² ch96 IC-GAN BigGAN generator with random weights
   from a seed, σ folded, bf16, behind ``make_sampler(batch_size=128)``,
   answering requests of 128, 200 and 1 images; kernel launches are counted
   over exactly these requests; then images per second at batch 128;
6. whole-generator parity: the same folded weights on the card in bf16 and
   in f32 against the CPU in f32.

The last three lines of standard output are the card (name, power limit),
one JSON object describing each kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ic_gan_tpu_torch.io.deploy import cast_params, fold_spectral_norm, make_sampler
from ic_gan_tpu_torch.models.biggan import BigGANConfig, Generator
from ic_gan_tpu_torch.models.layers import SelfAttention
from ic_gan_tpu_torch.ops import _build
from ic_gan_tpu_torch.ops.attention import sagan_attention, sagan_attention_ref

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, FP32 outside them,
# and HBM3 bandwidth.  The card's power limit is printed beside every time.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

MAIN_ATTN = (128, 4096, 1024, 48, 192)  # N, Lq, Lk, d, dv at the 256² G's 64² stage
# (name, shape, dtype, atol).  bf16: only the rounding point of p differs from
# the plain version (the bar of tests/test_pallas_attention.py).  f32: the
# kernel's online softmax and FMA order against cuBLAS's GEMM and softmax.
ATTN_CASES = [
    ("main bf16", MAIN_ATTN, torch.bfloat16, 3e-2),
    ("main f32", MAIN_ATTN, torch.float32, 2e-5),
    ("128^2 widths bf16", (128, 4096, 1024, 24, 96), torch.bfloat16, 3e-2),
    ("128^2 widths f32", (16, 4096, 1024, 24, 96), torch.float32, 2e-5),
    ("ragged bf16", (4, 1000, 250, 48, 192), torch.bfloat16, 3e-2),
    ("ragged f32", (4, 1000, 250, 48, 192), torch.float32, 2e-5),
    ("narrow ragged f32", (3, 77, 19, 8, 16), torch.float32, 2e-5),
]

MAIN_G = dict(resolution=256, G_ch=96, G_attn="64")  # the icgan res256 geometry
SAMPLER_BATCH = 128
REQUESTS = (128, 200, 1)
PARITY_BATCH = 2
# Card bf16 against CPU f32.  tests/test_deploy.py holds bf16 deployment to
# 0.05 on a G_ch 8 model, and tests/test_torch_port_generator.py holds the
# port to it at toy size.  At 256² ch96 that bar is out of reach for any
# bf16-weight deployment: rounding the weights alone, with f32 arithmetic,
# moves the output by up to 0.08 (phase 6 measures and prints this floor).
# So the full-size run bounds the largest and the mean deviation.
BF16_MAX_BAR = 0.25
BF16_MEAN_BAR = 0.02
F32_BAR = 1e-3     # card f32 against CPU f32; 2e-4 is the aim


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(shape, dtype):
    """Least time for softmax(θφᵀ)·g: the larger of its operations over the
    peak rate for the type and its bytes (inputs read once, output written
    once) over the memory rate."""
    n, lq, lk, d, dv = shape
    flops = 2.0 * n * lq * lk * (d + dv)
    nbytes = torch.finfo(dtype).bits // 8 * (n * lq * d + n * lk * d + n * lk * dv + n * lq * dv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def generator_flops_per_image(cfg) -> float:
    """Multiply-adds ×2 of one image through G, from its shapes: the
    polyphase up-convs (4 taps per output), 3×3 and 1×1 convs, the attention
    block and the output conv; the linears and batch-norm gains are left out
    (under 0.1 %)."""
    arch = cfg.g_arch
    total = 0.0
    r = cfg.bottom_width
    for cin, cout, attn in zip(arch["in_channels"], arch["out_channels"], arch["attention"]):
        hw = (2 * r) ** 2
        total += 2 * hw * cout * (4 * cin + 9 * cout) + 2 * r * r * cin * cout
        if attn:
            c8, c2 = cout // 8, cout // 2
            total += 2 * hw * (cout * (2 * c8 + c2) + hw // 4 * (c8 + c2) + c2 * cout)
        r *= 2
    return total + 2 * r * r * 9 * arch["out_channels"][-1] * 3


def attention_inputs(shape, dtype, seed=0, device="cuda"):
    """θ, φ ~ N(0, 1) and g ~ N(0, 0.25): the outputs, convex mixtures of g's
    rows, stay below 4 in magnitude, where one bf16 ulp (1/64) is under the
    3e-2 bar; both sides round the output to bf16."""
    n, lq, lk, d, dv = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    theta, phi, g = (torch.randn(s, generator=gen, device=device)
                     for s in ((n, lq, d), (n, lk, d), (n, lk, dv)))
    return theta.to(dtype), phi.to(dtype), (0.5 * g).to(dtype)


# --- phases ---------------------------------------------------------------------

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}  (devices: {torch.cuda.device_count()})")
    torch.cuda.set_device(0)
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} of {len(_build.sources())} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels() -> float:
    """Each case: max |kernel - plain| on the card.  Returns the main bf16 error."""
    errs = {}
    for name, shape, dtype, atol in ATTN_CASES:
        args = attention_inputs(shape, dtype)
        got = sagan_attention(*args)
        ref = sagan_attention_ref(*args)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"attention {name}: {got.shape}/{got.dtype} vs "
                                 f"{ref.shape}/{ref.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        log(f"attention {name} {shape}: max|kernel - plain| = {err:.3e} (atol {atol:g})")
        if not err <= atol:
            raise AssertionError(f"attention {name}: max abs err {err} > {atol}")
        errs[name] = err
    return errs["main bf16"]


def phase_timings() -> dict:
    args = attention_inputs(MAIN_ATTN, torch.bfloat16)
    t = dict(
        kernel_ms=cuda_ms(lambda: sagan_attention(*args)),
        plain_ms=cuda_ms(lambda: sagan_attention_ref(*args)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*args, scale=1.0)),
    )
    t["bound_ms"], t["bound_by"] = attention_bound_ms(MAIN_ATTN, torch.bfloat16)
    args32 = attention_inputs(MAIN_ATTN, torch.float32)
    f32 = dict(kernel_ms=cuda_ms(lambda: sagan_attention(*args32)),
               plain_ms=cuda_ms(lambda: sagan_attention_ref(*args32)))
    f32["bound_ms"], _ = attention_bound_ms(MAIN_ATTN, torch.float32)
    log("attention bf16 {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        "library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by})".format(MAIN_ATTN, **t))
    log("attention f32 {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        "bound_ms {bound_ms:.4f}".format(MAIN_ATTN, **f32))
    return t


def build_generator(device):
    """The 256² ch96 G with the port's own init from a seed: orthogonal
    weights, normal u, BN mean 0 and var 1; gamma set to 0.5 so that the
    attention shows in the output.  Returns the folded bf16 model and a copy
    of its folded f32 weights."""
    cfg = BigGANConfig(**MAIN_G, dtype=torch.bfloat16)
    g = Generator(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, SelfAttention):
                m.gamma.fill_(0.5)
    fold_spectral_norm(g)
    weights = {k: v.detach().clone() for k, v in g.state_dict().items()}
    cast_params(g, torch.bfloat16)
    return g, weights


def phase_main_path(device) -> dict:
    t0 = time.perf_counter()
    g, weights = build_generator(device)
    sampler = make_sampler(g, batch_size=SAMPLER_BATCH, device=device)
    torch.cuda.synchronize()
    cfg = g.cfg
    log(f"main path: {cfg.resolution}^2 ch{cfg.G_ch} G built, folded and cast in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(1)
    requests = [(torch.randn((n, cfg.effective_dim_z), generator=gen, device=device),
                 torch.randn((n, cfg.instance_sz), generator=gen, device=device))
                for n in REQUESTS]
    torch.cuda.synchronize()

    sagan_attention.launches = 0
    per_request = []
    for z, feats in requests:
        before = sagan_attention.launches
        imgs = sampler(z, feats=feats, device_output=True)
        torch.cuda.synchronize()
        n = z.shape[0]
        batches = math.ceil(n / SAMPLER_BATCH)
        launched = sagan_attention.launches - before
        finite = bool(torch.isfinite(imgs).all())
        lo, hi = imgs.min().item(), imgs.max().item()
        log(f"request {n}: images {tuple(imgs.shape)} {imgs.dtype} in [{lo:.4f}, {hi:.4f}], "
            f"{batches} batches, attention launches {launched}")
        res = cfg.resolution
        if imgs.shape != (n, res, res, 3) or not finite or lo < -1.0 or hi > 1.0:
            raise AssertionError(f"request {n}: bad images {tuple(imgs.shape)} "
                                 f"finite={finite} range=[{lo}, {hi}]")
        if launched != batches:
            raise AssertionError(f"request {n}: {launched} attention launches for {batches} batches")
        per_request.append(imgs.float().std().item())
    launches = sagan_attention.launches
    if launches == 0:
        raise AssertionError("the main path launched no attention kernel")
    if min(per_request) == 0.0:
        raise AssertionError("constant images")

    z, feats = requests[0]
    sampler(z, feats=feats, device_output=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sampler(z, feats=feats, device_output=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    flops = generator_flops_per_image(cfg)
    log(f"G: {flops / 1e9:.2f} GFLOP per image from its shapes; "
        f"{SAMPLER_BATCH * flops / med / 1e12:.1f} TFLOP/s achieved")
    log(f"sampler batch {SAMPLER_BATCH} bf16: {SAMPLER_BATCH / med:.2f} img/s "
        f"(median of {len(times)} passes, {1e3 * med:.2f} ms/batch; passes ms "
        f"{', '.join(f'{1e3 * t:.2f}' for t in times)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(g=g, weights=weights, sampler=sampler, launches=launches,
                requests=requests)


def phase_profile(main):
    """Device time of one sampler batch by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    z, feats = main["requests"][0]
    sampler = main["sampler"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler(z, feats=feats, device_output=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # operator rows repeat their kernels' time
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        log("profile: the trace holds no device time (not measured)")
        return
    log(f"profile: one batch of {SAMPLER_BATCH}: wall {1e3 * wall:.2f} ms, device busy "
        f"{total:.2f} ms ({100 * total / (1e3 * wall):.1f} % of wall)")
    for ms, count, key in sorted(rows, reverse=True)[:25]:
        log(f"  {ms:9.3f} ms {100 * ms / total:5.1f} %  x{count:<4d} {key[:110]}")


def phase_parity(main, device) -> None:
    """The folded weights on the card in bf16 and f32 against the CPU in f32;
    also the card in f32 with the weights rounded to bf16, the floor that
    weight rounding alone sets under the bf16 deviation."""
    cfg16 = main["g"].cfg
    cfg32 = cfg16.replace(dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(2)
    z = torch.randn((PARITY_BATCH, cfg16.effective_dim_z), generator=gen, device=device)
    feats = torch.randn((PARITY_BATCH, cfg16.instance_sz), generator=gen, device=device)

    def folded_f32(dev, round_to_bf16=False):
        g = fold_spectral_norm(skip_init(Generator, cfg32, device=dev))
        g.load_state_dict({k: v.to(dev) for k, v in main["weights"].items()})
        if round_to_bf16:
            cast_params(cast_params(g, torch.bfloat16), torch.float32)
        return g

    with torch.inference_mode():
        out16 = main["g"](z, None, feats).cpu()
        out32 = folded_f32(device)(z, None, feats).cpu()
        out_w = folded_f32(device, round_to_bf16=True)(z, None, feats).cpu()
        ref = folded_f32("cpu")(z.cpu(), None, feats.cpu())
    d16 = (out16 - ref).abs()
    err16, mean16 = d16.max().item(), d16.mean().item()
    err32 = (out32 - ref).abs().max().item()
    err_w = (out_w - ref).abs().max().item()
    met = "2e-4" if err32 <= 2e-4 else f"{F32_BAR:g}"
    log(f"whole G parity (batch {PARITY_BATCH}, {cfg16.resolution}^2 ch{cfg16.G_ch}, "
        f"against CPU f32): card bf16 max|d| {err16:.4e} mean|d| {mean16:.4e} "
        f"(bars {BF16_MAX_BAR}, {BF16_MEAN_BAR}); card f32 with bf16-rounded weights "
        f"max|d| {err_w:.4e}; card f32 max|d| {err32:.4e} (bar met: {met})")
    if not (torch.isfinite(ref).all() and err16 <= BF16_MAX_BAR
            and mean16 <= BF16_MEAN_BAR and err32 <= F32_BAR):
        raise AssertionError(f"whole-G parity failed: bf16 max {err16} mean {mean16}, "
                             f"f32 {err32}")


def main(argv) -> int:
    card = phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    max_err = phase_kernels()
    timings = phase_timings()
    main_run = phase_main_path(device)
    if "--profile" in argv:
        phase_profile(main_run)
    phase_parity(main_run, device)
    kernels = [dict(
        name="sagan_attention_fwd", route="cuda",
        source="ic_gan_tpu_torch/csrc/sagan_attention_fwd.cu",
        replaces="ic_gan_tpu/ops/pallas/attention.py:64",
        launches=main_run["launches"], max_abs_err=max_err,
        ms=timings["kernel_ms"], plain_ms=timings["plain_ms"],
        bound_ms=timings["bound_ms"], bound_by=timings["bound_by"],
        library_ms=timings["library_ms"],
    )]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
