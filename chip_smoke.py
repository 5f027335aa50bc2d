#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of IC-GAN on one GPU and check it.

    python3 chip_smoke.py              # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile    # adds device-time breakdowns

Phases, run in order; any failure ends the run with a non-zero exit:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build every kernel under ``ic_gan_tpu_torch/csrc`` with nvcc, in parallel,
   into ``ic_gan_tpu_torch/build/``, and count the tensor-core instructions
   of each bf16 attention kernel in its SASS;
3. every kernel against its plain PyTorch version on the card, at the two
   paths' shapes and a few others, with the tolerance stated beside each
   (the attention forward also its log-sum-exp; the backward also run twice
   for bit-identical results);
4. kernel timings at the paths' shapes: the kernel, its plain version, one
   library call computing the same function (a yardstick the port never
   calls), and the least time the card could take;
5. the sampler path: the 256² ch96 IC-GAN BigGAN generator with random
   weights from a seed, σ folded, bf16, behind ``make_sampler(batch_size=128)``,
   answering requests of 128, 200 and 1 images; kernel launches are counted
   over exactly these requests; then images per second at batch 128;
6. whole-generator parity: the same folded weights on the card in bf16 and
   in f32 against the CPU in f32;
7. the training path: the 256² ch96 G and D from a seed, bf16 compute,
   ``make_train_step`` at microbatch 32, one warm-up and 5 timed steps;
   kernel launches are counted over exactly these steps; then ms per step
   and images per second;
8. train-step parity: one step of a res-64 ch-16 G and D in f32 from the
   same weights and z on the card and on the CPU;
9. kernels B3 (ADA row shift; NaN rows for non-finite offsets) and B4
   (fused bias-activation: its forward and its backward kernel) against
   their plain versions on the card: B4 at
   the path shape and at the edges of its vector path, nine activations,
   bias or none, clamp or none; both to second order; f32 and bf16; then
   their timings at the StyleGAN2 path's shapes (B3 also at its adjoint's,
   B4's backward also as the plain formula that it replaced);
10. the StyleGAN2-ADA path: the IC-GAN 256² G and D (``h_dim`` 2048,
   ``channel_base`` 16384) from a seed, 'bgc' ADA on the fast geometry at p
   0.5, ``make_sg2_train_step`` at microbatch 16, a warm-up of each phase,
   then 5 main and 5 reg (path length and R1) steps; kernel launches are
   counted over exactly these steps and held to the counts derived from the
   model; then ms per step, s/kimg, img/s, TFLOP/s and peak memory;
11. StyleGAN2 train-step parity: a main and a reg step of a toy model in f32
   on the card (B3 and B4) and on the CPU (their plain versions), from the
   same weights and draws;
12. the StyleGAN2-ADA training loop: ``SG2Trainer.run`` for 7 steps at phase
   10's model and microbatch from an in-memory dataset drawn on the card,
   G and D regularized every 2 and 3 steps, so that every variant runs; B3
   and both B4 kernels launch in each, the main and pl+r1 steps as often as
   phase 10 derives; ADA's p, the tick records (s/kimg), the snapshots (size,
   save and load time), a bit-for-bit reload into a fresh trainer and one
   more step from it against the live one; then ``make_sampler`` over the
   EMA G with ``truncation_psi`` 0.7 and constant noise against direct calls.

``--profile`` adds device-time breakdowns of one sampler batch, one BigGAN
train step and one StyleGAN2 main and reg step, with the kernels launched
inside ``BiasAct.backward`` (its ``bias_act_bwd`` range) summed apart.  The
last three lines of standard output are the card (name, power limit), one
JSON object describing each kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.data.datasets import Batch
from ic_gan_tpu_torch.io.checkpoint import load_checkpoint
from ic_gan_tpu_torch.io.deploy import cast_params, fold_spectral_norm, make_sampler
from ic_gan_tpu_torch.models import stylegan2 as sg2
from ic_gan_tpu_torch.models.biggan import BigGANConfig, Discriminator, Generator
from ic_gan_tpu_torch.models.layers import SelfAttention
from ic_gan_tpu_torch.ops import _build
from ic_gan_tpu_torch.ops import bias_act as ba
from ic_gan_tpu_torch.ops import row_shift as rs
from ic_gan_tpu_torch.ops.attention import (
    sagan_attention_bwd,
    sagan_attention_bwd_ref,
    sagan_attention_fwd,
    sagan_attention_ref,
)
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
from ic_gan_tpu_torch.train import stylegan2_trainer as sg2_loop
from ic_gan_tpu_torch.train.stylegan2_step import (
    SG2TrainConfig,
    SG2TrainState,
    make_sg2_train_step,
)

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

# The training path's attention shapes at microbatch 32: G at 64², and D's
# block 1 (192 channels) at 64², where D sees fake and real together (N 64).
TRAIN_G_ATTN = (32, 4096, 1024, 48, 192)
TRAIN_D_ATTN = (64, 4096, 1024, 24, 96)
# (name, shape).  Bars: f32, the JAX bar atol 1e-4 (tests/test_pallas_attention.py:62)
# relative to max(1, max|plain|), since dφ and dg sum over up to 4096 queries
# in another order than cuBLAS; bf16, the JAX bar atol 5e-2 with rtol 2e-2
# (:96-98), as both sides round the same f32 sums to bf16.
BWD_CASES = [
    ("G", TRAIN_G_ATTN),
    ("D", TRAIN_D_ATTN),
    ("ragged", (4, 1000, 250, 48, 192)),
    ("narrow ragged", (3, 77, 19, 8, 16)),
]
BWD_F32_ATOL = 1e-4
BWD_BF16_TOL = dict(atol=5e-2, rtol=2e-2)
# The forward's log-sum-exp against the plain version's (torch.logsumexp of
# cuBLAS's f32 logits): f32 inputs atol 1e-5.  bf16 inputs: the kernel's
# logits come from the tensor cores' f32 accumulation, whose order and
# rounding differ from cuBLAS's by a few ulp of the largest logit (one ulp
# is 1.9e-6 at |lse| 16-32), so atol 1e-5 + rtol 1e-6; an lse error of
# 3.5e-5 moves p = exp(s - lse) by 3.5e-5 of itself, under a hundredth of
# one bf16 rounding.
LSE_F32_ATOL = 1e-5
LSE_BF16_TOL = dict(atol=1e-5, rtol=1e-6)

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

# The training path: the flagship geometry of README.md, the JAX train
# bench's 256² cell (benchmarks/bench_train_step.py:39-98, ema_start 0).
TRAIN_MODEL = dict(resolution=256, G_ch=96, D_ch=96, G_attn="64", D_attn="64")
TRAIN_MB = 32
TRAIN_STEPS = 5
# Card-against-CPU train step: f32, TF32 off.  Raw gradients: max|Δ| ≤
# 1e-2·max|ref| + 1e-5·(largest gradient of the network), per tensor.  f32
# reassociation noise amplified through batch norm at microbatch 4 and ReLU
# flips reaches 3e-3 of a tensor's largest entry between two CPU
# implementations (tests/test_torch_port_train.py), and the floor covers the
# biases before a batch norm, whose true gradient is 0.  adam_eps 1e-3 keeps
# D's first Adam step smooth in its gradient, as there.  SN and BN state:
# 1e-3 of the tensor's largest entry.
PARITY_MODEL = dict(resolution=64, G_ch=16, D_ch=16, G_attn="32", D_attn="32")
PARITY_MB = 4
PARITY_GRAD_REL, PARITY_GRAD_FLOOR, PARITY_STATE_REL = 1e-2, 1e-5, 1e-3

# --- the StyleGAN2-ADA path and kernels B3 and B4 ---------------------------------
# The JAX package's 256² StyleGAN2 train bench cell (benchmarks/bench_sg2_train.py:
# 62-110) with IC-GAN instance conditioning on, as StyleGAN2Config's own default.
SG2_MODEL = dict(img_resolution=256, z_dim=512, c_dim=0, h_dim=2048, w_dim=512,
                 channel_base=16384, channel_max=512)
SG2_MB = 16
SG2_STEPS = 5
SG2_P = 0.5          # every ADA transform draws for real; the work does not depend on p
# B3's path shape: 'bgc' pads 256² by 70 a side and upsamples 2× (792² canvas),
# so each shear pass shifts 16·3·792 rows of the 1584-wide scale window to 792.
B3_PATH = (SG2_MB * 3 * 792, 1584, 792)
# B4's largest path call: the 256² blocks of G and D, bf16.
B4_PATH = (SG2_MB, 64, 256, 256)
# B4's checks: the path shape, and the edges of its kernels' vector path.
# With a bias: the FC layers (inner 1, C a multiple of 8) take the row layout
# (the bias read as a vector); conv planes, odd C over 4x4 planes among them,
# the plane layout (a vector in one channel); 3x3 and 5x5 planes, an FC layer
# of odd C and contiguous views whose pointers are not 16-byte aligned the
# scalar path.  With no bias every aligned case takes the plane layout, its
# ragged tail the scalar path.
B4_CASES = [("path", B4_PATH), ("fc", (SG2_MB, 512)), ("conv 32^2", (4, 64, 32, 32)),
            ("3x3 planes", (4, 24, 3, 3)), ("5x5 planes", (4, 24, 5, 5)),
            ("odd C", (3, 7, 4, 4)), ("odd C fc", (5, 9)),
            ("storage offset 1", (2, 16, 4, 4))]
# Bars.  B3 (tests/test_row_shift.py:26, 56, 106): f32 1e-6, second order
# 1e-5; bf16 atol 2e-2 + rtol 2e-2 (both round one f32 lerp, but a fused
# multiply-add can land a value on the other side of a rounding boundary).
# B4 (tests/test_pallas_bias_act.py:23, 55, 68): f32 1e-6, first order 1e-5,
# second order 1e-4, each relative to max(1, max|plain|); bf16 atol 2e-2 +
# rtol 2e-2: the plain version rounds to bf16 after the add, the activation
# and the gain (2^-9 of a value each), the kernel once.
B3_F32, B3_F32_2ND, B4_F32, B4_1ST, B4_2ND = 1e-6, 1e-5, 1e-6, 1e-5, 1e-4
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# Card against CPU: a toy model, f32, TF32 off, with the BigGAN step's bars (losses 1e-4
# relative, raw gradients 1e-2 of each tensor's largest entry, w_avg and
# pl_mean 1e-3).  G's learning rate is 0 so that layer noise, whose draws
# differ between the card's generator and the CPU's, stays 0 (its strengths
# start at 0); their own gradients are left out.  adam_eps 1e-3 as there.
SG2_PARITY_MODEL = dict(img_resolution=32, z_dim=32, c_dim=0, h_dim=64, w_dim=32,
                        channel_base=1024, channel_max=64, num_fp16_res=0,
                        num_mapping_layers=2)
SG2_PARITY_MB = 4
# The StyleGAN2-ADA training loop at phase 10's model and microbatch: the
# regularization intervals 2 and 3 and 7 steps run every variant (0 pl+r1,
# 1 main, 2 pl, 3 r1, ...); ADA's p moves every 2 steps from 0.5 by 32/500 of
# a unit; a tick every 32 images (2 steps), a snapshot every tick.  The
# dataset is drawn on the card from a seed (no h5py on the card's machine).
SG2_LOOP_STEPS = 7
SG2_LOOP_TRAIN = dict(G_reg_interval=2, D_reg_interval=3, ada_interval=2, ada_kimg=0.5)
SG2_LOOP_TICK_KIMG = 0.032
SG2_LOOP_IMAGES = 64
SG2_LOOP_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_sg2_loop")
DEV = "cuda"         # the kernel phases' device (the CPU only to rehearse them)


def log(msg: str):
    print(msg, flush=True)


def reset_counts():
    """Every kernel's launch count to 0."""
    sagan_attention_fwd.launches = sagan_attention_bwd.launches = 0
    ba.reset_launches()
    rs.reset_launches()


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def counts() -> dict:
    return dict(B1=sagan_attention_fwd.launches, B2=sagan_attention_bwd.launches,
                B3=rs.row_shift_fwd.launches, B4=ba.bias_act_fwd.launches,
                B4bwd=ba.bias_act_bwd.launches)


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each run.
    For one launch this includes the host's time in the wrapper before the
    kernel starts: the stream is idle when the first event is recorded."""
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


def back_to_back_ms(fn, n: int = 10) -> float:
    """``cuda_ms`` of ``n`` calls of ``fn`` in a row, over ``n``: the host's
    time in the wrappers then overlaps the device's work.  Logged beside a
    kernel's ``cuda_ms`` to show how much of that is the host's."""
    return cuda_ms(lambda: [fn() for _ in range(n)]) / n


def host_us(fn, n: int = 100) -> float:
    """Host time of one call of ``fn`` in µs: ``n`` calls queued without
    waiting for the device (whose work per call is longer), over ``n``."""
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    sync()
    return 1e6 * t / n


def roofline_ms(nbytes, flops, dtype):
    """The least time for ``flops`` operations of ``dtype`` and ``nbytes``
    moved: the larger of the two over the card's peaks, and which bounds."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_flops(shape) -> float:
    """Operations of softmax(θφᵀ)·g: the two products, 2·N·Lq·Lk·(d + dv)."""
    n, lq, lk, d, dv = shape
    return 2.0 * n * lq * lk * (d + dv)


def attention_bwd_flops(shape) -> float:
    """Operations of (dθ, dφ, dg): 2·N·Lq·Lk·(3d + 2dv), the logits, dp, dθ,
    dφ and dg products."""
    n, lq, lk, d, dv = shape
    return 2.0 * n * lq * lk * (3 * d + 2 * dv)


def attention_bound_ms(shape, dtype):
    """Least time for softmax(θφᵀ)·g: the larger of its operations over the
    peak rate for the type and its bytes (inputs read once, output written
    once) over the memory rate."""
    n, lq, lk, d, dv = shape
    nbytes = torch.finfo(dtype).bits // 8 * (n * lq * d + n * lk * d + n * lk * dv + n * lq * dv)
    return roofline_ms(nbytes, attention_flops(shape), dtype)


def attention_bwd_bound_ms(shape, dtype):
    """Least time for (dθ, dφ, dg): its operations over the peak rate, against
    θ, φ, g and do read once and the three gradients written once (the
    forward's (N, Lq) f32 log-sum-exp adds under 0.5 %)."""
    n, lq, lk, d, dv = shape
    inputs = n * lq * d + n * lk * d + n * lk * dv + n * lq * dv
    grads = n * lq * d + n * lk * d + n * lk * dv
    nbytes = torch.finfo(dtype).bits // 8 * (inputs + grads)
    return roofline_ms(nbytes, attention_bwd_flops(shape), dtype)


def rates(t: dict, flops: float) -> dict:
    """``t`` with its achieved TFLOP/s (the bound's operations over the
    kernel's time) and its share of the bound (bound_ms / kernel_ms)."""
    t["tflops"] = flops / t["kernel_ms"] / 1e9
    t["of_bound"] = t["bound_ms"] / t["kernel_ms"]
    return t


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


def attention_inputs(shape, dtype, seed=0, device="cuda", with_do=False):
    """θ, φ ~ N(0, 1) and g ~ N(0, 0.25): the outputs, convex mixtures of g's
    rows, stay below 4 in magnitude, where one bf16 ulp (1/64) is under the
    3e-2 bar; both sides round the output to bf16.  ``with_do`` adds an
    output gradient do ~ N(0, 1)."""
    n, lq, lk, d, dv = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    theta, phi, g = (torch.randn(s, generator=gen, device=device)
                     for s in ((n, lq, d), (n, lk, d), (n, lk, dv)))
    out = [theta.to(dtype), phi.to(dtype), (0.5 * g).to(dtype)]
    if with_do:
        out.append(torch.randn((n, lq, dv), generator=gen, device=device).to(dtype))
    return out


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
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers a "
            f"thread; {sum(1 for b in spills if b)} spill, at most {max(spills, default=0)} bytes")


def phase_tensor_cores() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each attention
    kernel, from ``cuobjdump --dump-sass`` of the built libraries.  Fails if a
    bf16 instantiation (``*_mma``) has none.  Returns {kernel: count}."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts = {}
    for lib in ("sagan_attention_fwd", "sagan_attention_bwd"):
        sass = subprocess.run([tool, "--dump-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn is not None and re.search(r"\bHG?MMA\.", line):
                counts[fn] += 1
    named = {}
    for fn, n in counts.items():
        m = re.search(r"(sagan_attention_fwd_(?:mma|kernel)|attn_bwd_(?:q_mma|kv_mma|q_pass|k_pass))"
                      r"I((?:Li\d+E)+)", fn)
        name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>" if m else fn
        named[name] = n
    mma = {k: v for k, v in named.items() if "_mma" in k}
    log("tensor-core instructions (HMMA/HGMMA in SASS) of each bf16 instantiation: "
        + ", ".join(f"{k} {v}" for k, v in sorted(mma.items())))
    log("  f32 instantiations (CUDA cores): "
        + ", ".join(f"{k} {v}" for k, v in sorted(named.items()) if k not in mma))
    if not mma or min(mma.values()) == 0:
        raise AssertionError(f"a bf16 attention kernel has no tensor-core instruction: {mma}")
    return mma


def phase_kernels() -> dict:
    """Each case: max |kernel - plain| on the card.  Returns each kernel's
    error at its path's main bf16 shape."""
    errs = {}
    for name, shape, dtype, atol in ATTN_CASES:
        args = attention_inputs(shape, dtype)
        got, lse = sagan_attention_fwd(*args, return_lse=True)
        ref, ref_lse = sagan_attention_ref(*args, return_lse=True)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype or lse.shape != ref_lse.shape:
            raise AssertionError(f"attention {name}: {got.shape}/{got.dtype} vs "
                                 f"{ref.shape}/{ref.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        d_lse = (lse - ref_lse).abs()
        if dtype == torch.float32:
            lse_ok, lse_bar = d_lse.max().item() <= LSE_F32_ATOL, f"atol {LSE_F32_ATOL:g}"
        else:
            lse_ok = bool((d_lse <= LSE_BF16_TOL["atol"]
                           + LSE_BF16_TOL["rtol"] * ref_lse.abs()).all())
            lse_bar = "atol 1e-5 + rtol 1e-6"
        log(f"attention {name} {shape}: max|kernel - plain| = {err:.3e} (atol {atol:g}); "
            f"lse {d_lse.max().item():.3e} ({lse_bar}, max|lse| {ref_lse.abs().max().item():.2f})")
        if not err <= atol:
            raise AssertionError(f"attention {name}: max abs err {err} > {atol}")
        if not lse_ok:
            raise AssertionError(f"attention {name}: lse off by {d_lse.max().item()}")
        errs[name] = err
    bwd_err = None
    for name, shape in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = attention_inputs(shape, dtype, with_do=True)
            _, lse = sagan_attention_ref(*args[:3], return_lse=True)
            got = sagan_attention_bwd(*args, lse)
            torch.cuda.synchronize()
            ref = sagan_attention_bwd_ref(*args)
            worst = 0.0
            for gname, t, r, inp in zip(("dtheta", "dphi", "dg"), got, ref, args):
                if t.shape != inp.shape or t.dtype != inp.dtype or r.dtype != inp.dtype:
                    raise AssertionError(f"attention bwd {name} {gname}: {t.shape}/{t.dtype}")
                d = (t.float() - r.float()).abs()
                rmax = r.float().abs().max().item()
                if dtype == torch.float32:
                    bar = BWD_F32_ATOL * max(1.0, rmax)
                    ratio = d.max().item() / bar
                    how = f"bar {bar:.3e} = 1e-4·max(1, {rmax:.3e})"
                else:
                    ratio = (d / (BWD_BF16_TOL["atol"]
                                  + BWD_BF16_TOL["rtol"] * r.float().abs())).max().item()
                    how = "atol 5e-2 + rtol 2e-2"
                log(f"attention bwd {name} {shape} {str(dtype)[6:]} {gname}: max|kernel - plain| "
                    f"= {d.max().item():.3e}, max|plain| {rmax:.3e}, worst |Δ|/bar {ratio:.3f} "
                    f"({how})")
                if not ratio <= 1.0:
                    raise AssertionError(f"attention bwd {name} {dtype} {gname} out of bar")
                worst = max(worst, d.max().item())
            if name == "G" and dtype == torch.bfloat16:
                bwd_err = worst
                # No atomics: the same inputs give the same bits.
                again = sagan_attention_bwd(*args, lse)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"attention bwd G bf16 run twice: bit-identical {same}")
                if not same:
                    raise AssertionError("the attention backward is not deterministic")
                del again
            del got, ref, args
            torch.cuda.empty_cache()  # the plain version's (N, Lq, Lk) f32 temps
    return dict(fwd=errs["main bf16"], bwd=bwd_err)


def sdpa_bwd_ms(args) -> float:
    """The backward of ``F.scaled_dot_product_attention(..., scale=1.0)`` on
    the same inputs and output gradient: its forward+backward less its
    forward.  A yardstick only; the port never calls it."""
    theta, phi, g, do = (a.unsqueeze(1) for a in args)  # one head
    q, k, v = (a.detach().requires_grad_(True) for a in (theta, phi, g))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=1.0)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), do)

    with torch.no_grad():
        t_fwd = cuda_ms(fwd)
    return cuda_ms(fwd_bwd) - t_fwd


def phase_timings() -> dict:
    """The forward at the sampler's and the training step's shapes, bf16, as
    each path calls it (the sampler without the log-sum-exp, training with
    it); f32 at the sampler's shape."""
    t = {}
    for label, shape, with_lse in (("sampler", MAIN_ATTN, False), ("G", TRAIN_G_ATTN, True),
                                   ("D", TRAIN_D_ATTN, True)):
        a = attention_inputs(shape, torch.bfloat16)
        ts = dict(kernel_ms=cuda_ms(lambda: sagan_attention_fwd(*a, return_lse=with_lse)),
                  plain_ms=cuda_ms(lambda: sagan_attention_ref(*a, return_lse=with_lse)),
                  library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*a, scale=1.0)))
        ts["bound_ms"], ts["bound_by"] = attention_bound_ms(shape, torch.bfloat16)
        t[label] = rates(ts, attention_flops(shape))
        log("attention bf16 {} {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
            "library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by})  "
            "{tflops:.1f} TFLOP/s, {of_bound:.3f} of bound".format(label, shape, **ts))
        del a
    args32 = attention_inputs(MAIN_ATTN, torch.float32)
    f32 = dict(kernel_ms=cuda_ms(lambda: sagan_attention_fwd(*args32)),
               plain_ms=cuda_ms(lambda: sagan_attention_ref(*args32)))
    f32["bound_ms"], _ = attention_bound_ms(MAIN_ATTN, torch.float32)
    log("attention f32 {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        "bound_ms {bound_ms:.4f} (FP32 CUDA-core peak)".format(MAIN_ATTN, **f32))
    return t


def phase_bwd_timings() -> dict:
    """The backward at the training shapes, bf16: kernel, plain version of
    the same contract (with the forward's log-sum-exp), the library's
    backward and the bound."""
    out = {}
    for label, shape in (("G", TRAIN_G_ATTN), ("D", TRAIN_D_ATTN)):
        args = attention_inputs(shape, torch.bfloat16, with_do=True)
        _, lse = sagan_attention_fwd(*args[:3], return_lse=True)
        t = dict(kernel_ms=cuda_ms(lambda: sagan_attention_bwd(*args, lse)),
                 plain_ms=cuda_ms(lambda: sagan_attention_bwd_ref(*args, lse=lse),
                                  reps=3, warmup=1))
        torch.cuda.empty_cache()
        t["library_ms"] = sdpa_bwd_ms(args)
        t["bound_ms"], t["bound_by"] = attention_bwd_bound_ms(shape, torch.bfloat16)
        rates(t, attention_bwd_flops(shape))
        log("attention bwd bf16 {} {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
            "library_ms {library_ms:.4f} (SDPA fwd+bwd less fwd)  bound_ms {bound_ms:.4f} "
            "({bound_by})  {tflops:.1f} TFLOP/s, {of_bound:.3f} of bound".format(
                label, shape, **t))
        out[label] = t
        del args, lse
        torch.cuda.empty_cache()
    return out


def set_gamma(*nets):
    """Every attention gamma at 0.5, off its zero init, so that attention
    shows in the outputs and its gradients are not zero."""
    with torch.no_grad():
        for net in nets:
            for m in net.modules():
                if isinstance(m, SelfAttention):
                    m.gamma.fill_(0.5)


def build_generator(device):
    """The 256² ch96 G with the port's own init from a seed: orthogonal
    weights, normal u, BN mean 0 and var 1; gamma set to 0.5 so that the
    attention shows in the output.  Returns the folded bf16 model and a copy
    of its folded f32 weights."""
    cfg = BigGANConfig(**MAIN_G, dtype=torch.bfloat16)
    g = Generator(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    set_gamma(g)
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

    reset_counts()
    per_request = []
    for z, feats in requests:
        before = sagan_attention_fwd.launches
        imgs = sampler(z, feats=feats, device_output=True)
        torch.cuda.synchronize()
        n = z.shape[0]
        batches = math.ceil(n / SAMPLER_BATCH)
        launched = sagan_attention_fwd.launches - before
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
    launches = sagan_attention_fwd.launches
    if launches == 0 or sum(counts().values()) != launches:
        raise AssertionError(f"the sampler path launched {counts()}: B1 only, and B1 at least once")
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


def phase_profile(label, fn):
    """Device time of one call of ``fn`` by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # Operator rows and annotations ("Optimizer.step#Adam.step") repeat
        # their kernels' time.
        if e.device_type != DeviceType.CUDA or re.fullmatch(r"[\w.]+#[\w.]+", e.key) \
                or e.key == B4_BWD_RANGE:
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
    log(f"profile: {label}: wall {1e3 * wall:.2f} ms, device busy "
        f"{total:.2f} ms ({100 * total / (1e3 * wall):.1f} % of wall), "
        f"{sum(r[1] for r in rows)} kernel launches")
    classes = {}
    for ms, count, key in rows:
        c = kernel_class(key)
        classes[c] = tuple(a + b for a, b in zip(classes.get(c, (0.0, 0)), (ms, count)))
    for c, (ms, count) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        log(f"  class {c:<34s} {ms:9.3f} ms {100 * ms / total:5.1f} %  x{count}")
    for ms, count, key in sorted(rows, reverse=True)[:25]:
        log(f"  {ms:9.3f} ms {100 * ms / total:5.1f} %  x{count:<4d} {key[:110]}")
    calls, ms, n = range_kernels(prof, B4_BWD_RANGE)
    if calls:
        log(f"  range {B4_BWD_RANGE} (BiasAct.backward, B4's backward): {calls} calls, {n} "
            f"kernel launches, {ms:.3f} ms of device time ({100 * ms / total:.1f} %)")


B4_BWD_RANGE = "bias_act_bwd"   # the record_function range around BiasAct.backward


def range_kernels(prof, name):
    """(calls, device ms, launches) of the kernels launched inside every
    ``record_function(name)`` range: each kernel is attached to the host event
    that launched it, and those events are the range's descendants."""
    from torch.autograd import DeviceType

    ranges = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
    ms, n, seen = 0.0, 0, set()
    stack = list(ranges)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        ms += sum(k.duration for k in e.kernels) / 1e3
        n += len(e.kernels)
        stack.extend(e.cpu_children)
    return len(ranges), ms, n


# (class, substrings of the kernel name), matched in order.
_KERNEL_CLASSES = (
    ("attention forward B1", ("sagan_attention_fwd",)),
    ("attention backward B2", ("attn_bwd_",)),
    ("ADA row shift B3", ("row_shift",)),
    ("bias-activation B4 backward", ("bias_act_bwd",)),
    ("bias-activation B4", ("bias_act",)),
    ("cuDNN NCHW<->NHWC transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convs (cuDNN)", ("xmma", "implicit_gemm", "conv", "dgrad", "wgrad")),
    ("matmuls (cuBLAS and others)", ("gemm", "gemv", "nvjet", "Gemm")),
    ("reductions", ("reduce_kernel",)),
    ("copies and concatenation", ("copy", "Cat")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(key: str) -> str:
    for name, parts in _KERNEL_CLASSES:
        if any(p in key for p in parts):
            return name
    return "other"


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


def train_flops_per_step(cfg, mb) -> float:
    """Operations of one train step from the shapes: G forward is
    ``generator_flops_per_image``; D forward counts its convs (the pooled
    conv2 as a 4×4 stride-2 conv), 1×1 shortcuts and attention; linears are
    left out.  A backward costs twice its forward, half of that for the
    input gradients.  D phase: G forward on mb, D forward and backward on
    2·mb; G phase: G forward and backward, D forward and input gradients,
    on mb."""
    arch = cfg.d_arch
    d_img = 0.0
    r = cfg.resolution
    for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
        down = arch["downsample"][i]
        r_out = r // 2 if down else r
        d_img += 2 * r * r * 9 * cin * cout                      # conv1 (wide)
        d_img += 2 * r_out * r_out * (16 if down else 9) * cout * cout  # conv2
        if cin != cout or down:
            d_img += 2 * r_out * r_out * cin * cout               # conv_sc after the pool
        if arch["attention"][i]:
            hw, c8, c2 = r_out * r_out, cout // 8, cout // 2
            d_img += 2 * hw * (cout * (2 * c8 + c2) + hw // 4 * (c8 + c2) + c2 * cout)
        r = r_out
    g_img = generator_flops_per_image(cfg)
    return mb * ((g_img + 2 * 3 * d_img) + (3 * g_img + 2 * d_img))


def build_gan(model, dtype, device, seed):
    """G and D with the port's init from a seed, gamma 0.5."""
    cfg = BigGANConfig(**model, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = Generator(cfg, device=device, generator=gen)
    d = Discriminator(cfg, device=device, generator=gen)
    set_gamma(g, d)
    return cfg, g, d


def phase_train(device, profile: bool) -> dict:
    t0 = time.perf_counter()
    cfg, g, d = build_gan(TRAIN_MODEL, torch.bfloat16, device, seed=3)
    tcfg = TrainConfig(ema_start=0)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    step = make_train_step(tcfg, cfg.effective_dim_z)
    gen = torch.Generator(device=device).manual_seed(4)
    res, mb = cfg.resolution, TRAIN_MB
    batch = dict(x=torch.rand((1, mb, 3, res, res), generator=gen, device=device) * 2 - 1,
                 feats=torch.randn((1, mb, cfg.instance_sz), generator=gen, device=device),
                 gen_feats=torch.randn((2, mb, cfg.instance_sz), generator=gen, device=device))
    g_sn, d_sn = (next(m for m in net.modules() if isinstance(m, SelfAttention)).theta
                  for net in (g, d))
    bn = g.blocks[0][0].bn1
    watch = dict(g_u0=g_sn.u0, d_u0=d_sn.u0, g_bn_mean=bn.stored_mean,
                 g_weight=g.blocks[0][0].conv1.weight, d_weight=d.blocks[1][0].conv1.weight,
                 ema_weight=state.g_ema.blocks[0][0].conv1.weight)
    before = {k: v.detach().clone() for k, v in watch.items()}
    torch.cuda.synchronize()
    log(f"train path: {res}^2 G_ch {cfg.G_ch} D_ch {cfg.D_ch} G and D built in "
        f"{time.perf_counter() - t0:.1f} s; microbatch {mb}, bf16 compute, f32 weights")

    reset_counts()
    metrics_all = []
    times = []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        if i > 0:
            times.append(time.perf_counter() - t1)
        metrics_all.append({k: v.item() for k, v in metrics.items()})
    launches = dict(fwd=sagan_attention_fwd.launches, bwd=sagan_attention_bwd.launches)
    n_steps = 1 + TRAIN_STEPS
    for m in metrics_all:
        log("step: " + "  ".join(f"{k} {v:.4f}" for k, v in m.items()))
    if not all(math.isfinite(v) for m in metrics_all for v in m.values()):
        raise AssertionError("a loss or a non-finite count is not finite")
    if launches != dict(fwd=4 * n_steps, bwd=3 * n_steps) or counts()["B3"] \
            or counts()["B4"] or counts()["B4bwd"]:
        raise AssertionError(f"launches {counts()} over {n_steps} steps, expected B1 4 and "
                             "B2 3 per step, B3 and B4 none")
    unchanged = [k for k, v in watch.items() if torch.equal(v, before[k])]
    if unchanged:
        raise AssertionError(f"the train step left {unchanged} unchanged")
    med = statistics.median(times)
    flops = train_flops_per_step(cfg, mb)
    log(f"train: attention launches over {n_steps} steps: B1 {launches['fwd']}, "
        f"B2 {launches['bwd']} (4 and 3 per step); params, SN u0 of a G and a D layer, "
        f"a BN stored_mean and the EMA weights all changed")
    log(f"train step {res}^2 ch{cfg.G_ch} mb {mb} bf16: {1e3 * med:.2f} ms/step (median of "
        f"{len(times)}; passes ms {', '.join(f'{1e3 * t:.2f}' for t in times)}), "
        f"{mb / med:.2f} img/s (D-real images per step over step time); "
        f"{flops / 1e12:.2f} TFLOP per step from the shapes, {flops / med / 1e12:.1f} TFLOP/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        phase_profile(f"one train step at microbatch {mb}",
                      lambda: step(state, batch, gen))
    return launches


def phase_train_parity(device) -> None:
    """One train step from the same weights, batch and z on the card and on
    the CPU, f32 (TF32 off since phase 1): losses, raw gradients, SN and BN
    state."""
    tcfg = TrainConfig(ema_start=0, adam_eps=1e-3)
    cfg, g_cpu, d_cpu = build_gan(PARITY_MODEL, torch.float32, "cpu", seed=5)
    nets = {}
    for label, dev in (("cpu", "cpu"), ("card", device)):
        g = skip_init(Generator, cfg, device=dev)
        d = skip_init(Discriminator, cfg, device=dev)
        g.load_state_dict(g_cpu.state_dict())
        d.load_state_dict(d_cpu.state_dict())
        nets[label] = (g, d)
    gen = torch.Generator().manual_seed(6)
    res, mb = cfg.resolution, PARITY_MB
    batch = dict(x=torch.rand((1, mb, 3, res, res), generator=gen) * 2 - 1,
                 feats=torch.randn((1, mb, cfg.instance_sz), generator=gen),
                 gen_feats=torch.randn((2, mb, cfg.instance_sz), generator=gen))
    zs = [torch.randn((mb, cfg.effective_dim_z), generator=gen) for _ in range(2)]
    out = {}
    for label, (g, d) in nets.items():
        state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
        before = sagan_attention_bwd.launches
        dev = g.linear.weight.device
        _, m = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True)(
            state, {k: v.to(dev) for k, v in batch.items()}, zs=[z.to(dev) for z in zs])
        if label == "card" and sagan_attention_bwd.launches == before:
            raise AssertionError("the card's step did not launch the attention backward")
        out[label] = (m, g, d)
    (m_cpu, g_c, d_c), (m_gpu, g_g, d_g) = out["cpu"], out["card"]
    worst = {}
    for k in ("D_loss_real", "D_loss_fake", "G_loss"):
        a, b = m_gpu[k].item(), m_cpu[k].item()
        worst[k] = abs(a - b) / max(abs(b), 1e-6)
        if not worst[k] <= 1e-4:
            raise AssertionError(f"train parity {k}: card {a} CPU {b}")
    for which in ("d_grads", "g_grads"):
        top = max(v.abs().max().item() for v in m_cpu[which].values())
        rel = 0.0
        for k, r in m_cpu[which].items():
            err = (m_gpu[which][k].cpu() - r).abs().max().item()
            rmax = r.abs().max().item()
            if not err <= PARITY_GRAD_REL * rmax + PARITY_GRAD_FLOOR * top:
                raise AssertionError(f"train parity {which} {k}: max|Δ| {err} (max|ref| {rmax})")
            rel = max(rel, err / max(rmax, PARITY_GRAD_FLOOR * top / PARITY_GRAD_REL))
        worst[which] = rel
    rel = 0.0
    n_state = 0
    for net_g, net_c in ((g_g, g_c), (d_g, d_c)):
        sd_c = net_c.state_dict()
        for k, v in net_g.state_dict().items():
            if k.endswith((".u0", ".sv0", ".stored_mean", ".stored_var")):
                err = (v.cpu() - sd_c[k]).abs().max().item()
                rmax = sd_c[k].abs().max().item()
                if not err <= PARITY_STATE_REL * rmax:
                    raise AssertionError(f"train parity state {k}: max|Δ| {err}")
                rel = max(rel, err / rmax)
                n_state += 1
    worst["state"] = rel
    log(f"train-step parity ({res}^2 ch{cfg.G_ch} attention at 32, mb {mb}, f32, card "
        f"against CPU): worst relative |Δ|: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({n_state} SN/BN buffers; bars: losses 1e-4, grads {PARITY_GRAD_REL:g} of the "
        f"tensor's max + {PARITY_GRAD_FLOOR:g} of the network's, state {PARITY_STATE_REL:g})")


def _close(got, ref, f32_bar, what):
    """Kernel output against the plain version: f32 max|Δ| ≤ bar·max(1,
    max|plain|), bf16 within BF16_TOL; a NaN on both sides at one place
    counts as equal, on one side only as out of bar.  Returns max|Δ|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(ref.shape)}/{ref.dtype}")
    g, r = got.float(), ref.float()
    both_nan = torch.isnan(g) & torch.isnan(r)
    g, r = g.masked_fill(both_nan, 0.0), r.masked_fill(both_nan, 0.0)
    d = (g - r).abs()
    err = d.max().item() if d.numel() else 0.0
    if got.dtype == torch.bfloat16:
        ok = bool((d <= BF16_TOL["atol"] + BF16_TOL["rtol"] * r.abs()).all())
    else:
        ok = err <= f32_bar * max(1.0, r.abs().max().item())
    if not ok:
        raise AssertionError(f"{what}: max|kernel - plain| {err:.3e} out of bar")
    return err


def row_shift_case(rows, L, l_out, lo, hi, dtype, seed, integer=False):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((rows, L), generator=gen, device=DEV).to(dtype)
    off = lo + (hi - lo) * torch.rand((rows,), generator=gen, device=DEV)
    return x, (off.round() if integer else off), l_out


def b3_window_bytes(x, off, l_out) -> int:
    """Bytes B3 must move for these offsets: each row's in-frame window of
    [k, k + l_out] read once, the output written once."""
    L, item = x.shape[1], x.element_size()
    k = torch.floor(off).to(torch.int64)
    n_in = (torch.clamp(k + l_out + 1, max=L) - torch.clamp(k, min=0)).clamp(min=0).sum().item()
    return item * (n_in + x.shape[0] * l_out)


def phase_b3_b4() -> dict:
    """B3 and B4 against their plain versions on the card."""
    rows, L, l_out = B3_PATH
    errs = dict(B3=0.0)
    # Offsets as the shear passes give them (the window mostly in frame),
    # and beyond both ends of the frame in the ragged case.
    cases = [("path", (rows, L, l_out, -40.0, L - l_out + 40.0)),
             ("adjoint", (rows, l_out, L, -(L - l_out) - 40.0, 40.0)),
             ("ragged", (1001, 333, 517, -700.0, 700.0)),
             ("integer", (512, 200, 200, -220.0, 220.0))]
    for name, (r, length, lo_, a, b) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, off, n_out = row_shift_case(r, length, lo_, a, b, dtype, seed=11,
                                           integer=(name == "integer"))
            if name == "ragged":   # non-finite offsets: NaN rows on both sides
                off[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
            got = rs.row_shift_fwd(x, off, n_out)
            sync()
            err = _close(got, rs.row_shift_ref(x, off, n_out), B3_F32, f"B3 {name} {dtype}")
            if name == "integer" and dtype == torch.float32 and err != 0.0:
                raise AssertionError(f"B3 integer shifts: max|Δ| {err}, expected exact")
            if name == "ragged" and not (torch.isnan(got[:3]).all()
                                         and not torch.isnan(got[3:]).any()):
                raise AssertionError("B3: NaN rows where the offset is not finite, and only there")
            log(f"B3 {name} ({r}, {length}) -> {lo_} {str(dtype)[6:]}: max|kernel - plain| "
                f"{err:.3e}")
            if name == "path" and dtype == torch.float32:
                errs["B3"] = err
            del x, got
    # First and second order through RowShift against autograd of the plain
    # version (its gathers differentiate to any order).
    x, off, n_out = row_shift_case(4096, 400, 200, -150.0, 350.0, torch.float32, seed=12)
    grads = []
    for fn in (rs.row_shift, rs.row_shift_ref):
        xx = x.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad(torch.sin(fn(xx, off, n_out)).sum(), xx, create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xx)
        grads.append((g1.detach(), g2))
    e1 = _close(grads[0][0], grads[1][0], B3_F32, "B3 first order")
    e2 = _close(grads[0][1], grads[1][1], B3_F32_2ND, "B3 second order")
    log(f"B3 gradients (4096, 400) -> 200 f32: first order {e1:.3e}, second order {e2:.3e}")

    gen = torch.Generator(device=DEV).manual_seed(13)
    for name, shape in B4_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            worst = b4_case(name, shape, dtype, gen)
            log(f"B4 {name} {shape} {str(dtype)[6:]}, 9 activations x bias or none x clamp or "
                f"none: worst max|kernel - plain| forward {worst['fwd']:.3e}, backward "
                f"{worst['bwd']:.3e}")
            if name == "path" and dtype == torch.bfloat16:
                errs["B4"], errs["B4bwd"] = worst["path_fwd"], worst["path_bwd"]
    log(f"B4 path {B4_PATH} bf16 lrelu, gain {math.sqrt(2.0):.4f}, clamp 256: max|kernel - "
        f"plain| forward {errs['B4']:.3e}, backward {errs['B4bwd']:.3e}")
    # Gradients to second order: BiasAct (forward kernel; backward BiasActGrad,
    # whose own backward is the backward kernel again) against autograd
    # through the plain version.
    x = torch.randn((4, 64, 16, 16), generator=gen, device=DEV)
    b = torch.randn((64,), generator=gen, device=DEV)
    w1 = w2 = 0.0
    bwd_before = ba.bias_act_bwd.launches
    for act in ba.activation_funcs:
        out = []
        for fn in (ba.bias_act, ba.bias_act_ref):
            xx, bb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
            y = fn(xx, bb, 1, act, None, None, 1.0 if act in ("lrelu", "relu", "swish") else None)
            gx, gb = torch.autograd.grad(y.square().sum(), (xx, bb), create_graph=True)
            (h,) = torch.autograd.grad(gx.square().sum(), xx)
            out.append((gx.detach(), gb.detach(), h))
        w1 = max(w1, _close(out[0][0], out[1][0], B4_1ST, f"B4 {act} d/dx"),
                 _close(out[0][1], out[1][1], B4_1ST, f"B4 {act} d/db"))
        w2 = max(w2, _close(out[0][2], out[1][2], B4_2ND, f"B4 {act} second order"))
    bwd_launched = ba.bias_act_bwd.launches - bwd_before
    log(f"B4 gradients (4, 64, 16, 16) f32, 9 activations: first order {w1:.3e}, "
        f"second order {w2:.3e}; the backward kernel launched {bwd_launched} times (3 each)")
    if DEV == "cuda" and bwd_launched != 3 * len(ba.activation_funcs):
        raise AssertionError(f"B4 gradients launched the backward kernel {bwd_launched} times")
    return errs


def b4_case(name, shape, dtype, gen) -> dict:
    """Both B4 kernels against their plain versions on one input, every
    activation, bias or none, clamp or none.  The forward against
    ``bias_act_ref`` in the same type (bars ``_close``); the backward
    against ``_grad_x_ref``: f32 within B4_1ST of max(1, max|plain|); bf16
    within BF16_TOL of the plain version evaluated in f32 on the upcast
    inputs and rounded once, since the bf16 plain version rounds d·gain and
    the clamp test in bf16 and so flips elements at the clamp's edge."""
    scale = 30.0 if name == "path" else 2.0
    if name == "storage offset 1":   # contiguous views whose pointers are not 16-byte aligned
        x, b, gy = (torch.randn((math.prod(s) + 1,), generator=gen, device=DEV).to(dtype)[1:]
                    .view(s) for s in (shape, shape[1:2], shape))
    else:
        x = (scale * torch.randn(shape, generator=gen, device=DEV)).to(dtype)
        b = torch.randn((shape[1],), generator=gen, device=DEV).to(dtype)
        gy = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    up = (lambda t: None if t is None else t.float()) if dtype == torch.bfloat16 \
        else (lambda t: t)
    worst = dict(fwd=0.0, bwd=0.0)
    for act in ba.activation_funcs:
        for bias in (b, None):
            for clamp in ((256.0 if name == "path" else 1.0), None):
                what = f"B4 {name} {act} {dtype} bias {bias is not None} clamp {clamp}"
                e_f = _close(ba.bias_act_fwd(x, bias, 1, act, None, None, clamp),
                             ba.bias_act_ref(x, bias, 1, act, None, None, clamp), B4_F32, what)
                ref = ba._grad_x_ref(up(gy), up(x), up(bias), 1, act, None, None, clamp)
                e_b = _close(ba.bias_act_bwd(gy, x, bias, 1, act, None, None, clamp),
                             ref.to(dtype), B4_1ST, what + " backward")
                worst["fwd"], worst["bwd"] = max(worst["fwd"], e_f), max(worst["bwd"], e_b)
                if act == "lrelu" and bias is not None and clamp is not None:
                    worst["path_fwd"], worst["path_bwd"] = e_f, e_b
    del x, b, gy
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return worst


def phase_b3_b4_timings() -> dict:
    rows, L, l_out = B3_PATH
    out = {}
    # The path shape, and its adjoint (the G phase's backward and R1): rows of
    # l_out shifted by -off back to L.
    for label, (length, n_out, lo, hi) in (("path", (L, l_out, -40.0, L - l_out + 40.0)),
                                           ("adjoint", (l_out, L, -(L - l_out) - 40.0, 40.0))):
        x, off, _ = row_shift_case(rows, length, n_out, lo, hi, torch.float32, seed=14)
        # The library yardstick: grid_sample over (rows, 1, 1, length), bilinear
        # with zero padding; output l reads x at l + off, i.e. the normalized
        # coordinate (2·(l + off) + 1)/length − 1.  The port never calls it.
        pos = torch.arange(n_out, device=DEV, dtype=torch.float32)[None, :] + off[:, None]
        grid = torch.stack([(2 * pos + 1) / length - 1, torch.zeros_like(pos)], -1)[:, None]
        img = x[:, None, None, :]

        def library():
            return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)

        lib_err = (library()[:, 0, 0] - rs.row_shift_ref(x, off, n_out)).abs().max().item()
        nbytes = b3_window_bytes(x, off, n_out)
        t = dict(kernel_ms=cuda_ms(lambda: rs.row_shift_fwd(x, off, n_out)),
                 plain_ms=cuda_ms(lambda: rs.row_shift_ref(x, off, n_out)),
                 library_ms=cuda_ms(library))
        # Three operations an output (two products and a sum), f32.
        t["bound_ms"], t["bound_by"] = roofline_ms(nbytes, 3.0 * rows * n_out, torch.float32)
        t["of_bound"] = t["bound_ms"] / t["kernel_ms"]
        b2b = back_to_back_ms(lambda: rs.row_shift_fwd(x, off, n_out))
        host = host_us(lambda: rs.row_shift_fwd(x, off, n_out))
        log("B3 f32 {} ({}, {}) -> {}: kernel_ms {kernel_ms:.4f} (back to back {b2b:.4f}; "
            "the wrapper's host time {host:.1f} us a call)  "
            "plain_ms {plain_ms:.4f}  "
            "library_ms {library_ms:.4f} (grid_sample; it agrees with the plain version to "
            "{err:.1e})  bound_ms {bound_ms:.4f} ({bound_by}, {mb:.1f} MB for this run's "
            "offsets), {of_bound:.3f} of bound".format(label, rows, length, n_out, err=lib_err,
                                                       mb=nbytes / 1e6, b2b=b2b, host=host, **t))
        out["B3" if label == "path" else "B3_adjoint"] = t
        del x, grid, img, pos
    gen = torch.Generator(device=DEV).manual_seed(15)
    x = (torch.randn(B4_PATH, generator=gen, device=DEV) * 30).bfloat16()
    b = torch.randn((B4_PATH[1],), generator=gen, device=DEV).bfloat16()
    gy = torch.randn(B4_PATH, generator=gen, device=DEV).bfloat16()
    args = (x, b, 1, "lrelu", None, None, 256.0)
    item = x.element_size()
    b4 = dict(kernel_ms=cuda_ms(lambda: ba.bias_act_fwd(*args)),
              plain_ms=cuda_ms(lambda: ba.bias_act_ref(*args)), library_ms=None)
    # Five f32 operations an element: the add, the compare-select, the gain
    # and the two-sided clamp; x read and y written once, b read once.
    b4["bound_ms"], b4["bound_by"] = roofline_ms(2 * x.numel() * item + b.numel() * item,
                                                 5.0 * x.numel(), torch.float32)
    b4["of_bound"] = b4["bound_ms"] / b4["kernel_ms"]
    # What PyTorch's own elementwise kernels reach on the same bytes, for
    # scale beside the bound, logged back to back beside the kernel's own
    # back-to-back time: a copy (one read, one write) for the forward, a
    # product of two tensors (two reads, one write) for the backward.
    dst = torch.empty_like(x)
    log("B4 bf16 {} lrelu + bias + clamp: kernel_ms {kernel_ms:.4f} (back to back {b2b:.4f}; "
        "the wrapper's host time {host:.1f} us a call)  "
        "plain_ms {plain_ms:.4f}  "
        "library_ms none (no one PyTorch call computes clamp(gain·act(x + b)))  bound_ms "
        "{bound_ms:.4f} ({bound_by}), {of_bound:.3f} of bound; a copy of the same bytes "
        "back to back {copy:.4f} ms".format(
            B4_PATH, b2b=back_to_back_ms(lambda: ba.bias_act_fwd(*args)),
            host=host_us(lambda: ba.bias_act_fwd(*args)), copy=back_to_back_ms(lambda: dst.copy_(x)), **b4))

    def backward(grad_x):   # as BiasAct.backward runs it: gx, then torch's bias sum
        gx = grad_x(gy, *args)
        return gx, ba._sum_to_bias(gx, b, 1)

    bwd = dict(kernel_ms=cuda_ms(lambda: ba.bias_act_bwd(gy, *args)),
               plain_ms=cuda_ms(lambda: ba._grad_x_ref(gy, *args)), library_ms=None)
    # gy and x read and gx written once, b read once; nine f32 operations an
    # element (the add, the slope's select, two products, the activation's
    # select and product, the gain, |·| ≤ clamp and the mask's select).
    bwd["bound_ms"], bwd["bound_by"] = roofline_ms(3 * x.numel() * item + b.numel() * item,
                                                   9.0 * x.numel(), torch.float32)
    bwd["of_bound"] = bwd["bound_ms"] / bwd["kernel_ms"]
    log("B4 backward bf16 {} lrelu + bias + clamp: kernel_ms {kernel_ms:.4f} (back to back "
        "{b2b:.4f}; the wrapper's host time {host:.1f} us a call)  plain_ms {plain_ms:.4f} (gx alone)  library_ms none  bound_ms "
        "{bound_ms:.4f} ({bound_by}), {of_bound:.3f} of bound; gy·x back to back {mul:.4f} ms; "
        "the whole backward (gx and gb) {whole:.4f} ms, as the plain formula {whole_plain:.4f} "
        "ms".format(B4_PATH, b2b=back_to_back_ms(lambda: ba.bias_act_bwd(gy, *args)),
                    host=host_us(lambda: ba.bias_act_bwd(gy, *args)),
                    mul=back_to_back_ms(lambda: torch.mul(gy, x, out=dst)),
                    whole=cuda_ms(lambda: backward(ba.bias_act_bwd)),
                    whole_plain=cuda_ms(lambda: backward(ba._grad_x_ref)), **bwd))
    return dict(out, B4=b4, B4bwd=bwd)


def sg2_flops(g, d, pipe_canvas, mb, reg: bool) -> float:
    """Operations of one StyleGAN2-ADA step from the shapes (multiply-adds
    ×2).  G forward: the modulated convs (the up-convs as four 3×3 phase
    convs at the input's size), torgb, the FCs.  D forward: 3×3 convs, the
    strided 6×6 and 4×4 composite convs, fromrgb, the epilogue, the FCs.
    ADA: the two scale products of each warp pass.  A backward costs twice
    its forward, one that forms only input gradients once, and
    differentiating a first gradient twice that gradient.  Main: G phase
    3·G + 2·D + 2·ADA, D phase G + 2·(3·D + ADA).  Reg adds path length on
    mb/2 (G + G + 2·G) and R1 on mb (D + 2·D + ADA + ADA)."""
    def fc_flops(net):
        return sum(2.0 * m.weight.numel() for m in net.modules()
                   if isinstance(m, sg2.FullyConnected))

    def g_flops():
        total = fc_flops(g)
        for r in g.synthesis.block_resolutions:
            blk = getattr(g.synthesis, f"b{r}")
            for name in ("conv0", "conv1"):
                layer = getattr(blk, name, None)
                if layer is not None:
                    o, i, k, _ = layer.weight.shape
                    total += 2.0 * k * k * i * o * r * r
            o, i = blk.torgb.weight.shape[:2] if hasattr(blk, "torgb") else (0, 0)
            total += 2.0 * i * o * r * r
        return total

    def d_flops():
        total = fc_flops(d)
        for r in d.block_resolutions:
            blk = getattr(d, f"b{r}")
            if hasattr(blk, "fromrgb"):
                total += 2.0 * blk.fromrgb.weight[:, :, 0, 0].numel() * r * r
            o, i = blk.conv0.weight.shape[:2]
            total += 2.0 * 9 * i * o * r * r
            o, i = blk.conv1.weight.shape[:2]
            total += 2.0 * 36 * i * o * (r // 2) ** 2
            o, i = blk.skip.weight.shape[:2]
            total += 2.0 * 16 * i * o * (r // 2) ** 2
        o, i = d.b4.conv.weight.shape[:2]
        return total + 2.0 * 9 * i * o * 16

    c, canvas = g.cfg.img_channels, pipe_canvas
    ada = 2 * 2.0 * c * canvas * canvas * (2 * canvas)   # two passes, each (rows × L × 2L)
    gf, df = g_flops(), d_flops()
    total = mb * (4 * gf + 8 * df + 4 * ada)
    if reg:
        total += (mb // 2) * 4 * gf + mb * (3 * df + 2 * ada)
    return total


def build_sg2(model, device, seed):
    cfg = sg2.StyleGAN2Config(**model)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, sg2.Generator(cfg, device=device, generator=gen), \
        sg2.Discriminator(cfg, device=device, generator=gen)


def sg2_expected_launches(g, d) -> dict:
    """B3 and B4 launches a main and a reg step must make.

    B4 forward: every FullyConnected, SynthesisLayer, ToRGB and Conv2d calls
    ``bias_act`` once per forward; a step runs G's mapping twice per
    generated batch (style mixing), the synthesis once, and D on the G
    phase's fakes, the D phase's fakes and the reals; path length adds one
    mapping and one synthesis; R1 takes its gradient from the reals' forward.

    B4 backward: ``BiasAct.backward`` launches it once for each call a
    backward pass reaches, and autograd runs each node once per pass.  Main:
    the G phase reaches both mappings and the synthesis, and D's layers on
    the fakes but not D's mapping network (its input and weights need no
    gradient there); the D phase reaches every layer of D, on the fakes and on
    the reals.  Reg adds: path length's gradient (in ws, with a graph)
    through the synthesis; in the G phase's backward, that pass's forward
    nodes that its gradient depends on: the styles (the affine
    FullyConnecteds), the SynthesisLayer outputs (each the input of a
    modulated conv, whose style gradient reads it) and the mapping upstream
    of them, not the ToRGB outputs (they only feed the image sum); R1's
    gradient (in the reals, with a graph) through D but its mapping network.
    In the double backward, each ``BiasActGrad`` of those two gradients
    launches the kernel once more for its gradient in gy, where gy needs one:
    all of R1's, and path length's but the ToRGBs' (their gy is the noise,
    a constant).

    B3: each ADA warp is two shear passes: 3 warps a step, forward; the G
    phase's backward takes the adjoint of its 2; R1 adds the adjoint of the
    reals' 2, and D's update the adjoint of those adjoints (order 2)."""
    kinds = (sg2.FullyConnected, sg2.SynthesisLayer, sg2.ToRGB, sg2.Conv2d)
    n = lambda net: sum(isinstance(m, kinds) for m in net.modules())  # noqa: E731
    n_map, n_syn, n_d = n(g.mapping), n(g.synthesis), n(d)
    n_dmap = n(d.mapping) if hasattr(d, "mapping") else 0
    n_rgb = sum(isinstance(m, sg2.ToRGB) for m in g.synthesis.modules())
    main_b4 = 4 * n_map + 2 * n_syn + 3 * n_d
    main_bwd = 2 * n_map + n_syn + (n_d - n_dmap) + 2 * n_d
    reg_bwd = (main_bwd + n_syn + (n_map + n_syn - n_rgb) + (n_d - n_dmap)
               + (n_syn - n_rgb) + (n_d - n_dmap))
    return dict(main=dict(B4=main_b4, B4bwd=main_bwd, B3={0: 6, 1: 2}),
                reg=dict(B4=main_b4 + n_map + n_syn, B4bwd=reg_bwd, B3={0: 6, 1: 4, 2: 2}))


def phase_sg2_train(device, profile: bool) -> dict:
    t0 = time.perf_counter()
    cfg, g, d = build_sg2(SG2_MODEL, device, seed=21)
    tcfg = SG2TrainConfig()
    state = SG2TrainState.create(g, d, tcfg)
    state.ada_p = torch.full((), SG2_P, device=device)
    res, mb = cfg.img_resolution, SG2_MB
    pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")
    steps = {name: make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg, augment_fn=pipe)
             for name, reg in (("main", False), ("reg", True))}
    gen = torch.Generator(device=device).manual_seed(22)
    batch = dict(x=torch.rand((mb, 3, res, res), generator=gen, device=device) * 2 - 1,
                 h=torch.randn((mb, cfg.h_dim), generator=gen, device=device),
                 gen_h=torch.randn((mb, cfg.h_dim), generator=gen, device=device))
    watch = dict(g_weight=getattr(g.synthesis, f"b{res // 4}").conv1.weight,
                 g_mapping=g.mapping.fc0.weight, d_weight=getattr(d, f"b{res // 2}").conv0.weight,
                 w_avg=g.mapping.w_avg,
                 ema_weight=getattr(state.g_ema.synthesis, f"b{res // 4}").conv1.weight)
    before = {k: v.detach().clone() for k, v in watch.items()}
    expected = sg2_expected_launches(g, d)
    torch.cuda.synchronize()
    log(f"sg2 path: {res}^2 IC-GAN StyleGAN2 (h_dim {cfg.h_dim}, channel_base "
        f"{cfg.channel_base}) G and D built in {time.perf_counter() - t0:.1f} s; microbatch "
        f"{mb}, bf16 in the top {cfg.num_fp16_res} resolutions, 'bgc' ADA fast geometry at p "
        f"{SG2_P}")
    for name in ("main", "reg"):   # warm-up: one step of each
        state, m = steps[name](state, batch, gen)
    torch.cuda.synchronize()
    pl_after_warmup = state.pl_mean.item()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, per_phase, metrics_all = {}, {}, []
    for name in ("main", "reg"):
        c0 = dict(counts(), by_order=dict(rs.row_shift_fwd.launches_by_order))
        times[name] = []
        for _ in range(SG2_STEPS):
            t1 = time.perf_counter()
            state, m = steps[name](state, batch, gen)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t1)
            metrics_all.append((name, {k: v.item() for k, v in m.items()}))
        c1 = dict(counts(), by_order=dict(rs.row_shift_fwd.launches_by_order))
        per_phase[name] = dict(
            B4=c1["B4"] - c0["B4"], B4bwd=c1["B4bwd"] - c0["B4bwd"], B3=c1["B3"] - c0["B3"],
            B3_by_order={k: v - c0["by_order"].get(k, 0) for k, v in c1["by_order"].items()
                         if v != c0["by_order"].get(k, 0)},
            B1=c1["B1"] - c0["B1"], B2=c1["B2"] - c0["B2"])
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, m in metrics_all:
        log(f"sg2 {name} step: " + "  ".join(f"{k} {v:.4f}" for k, v in m.items()))
    if not all(math.isfinite(v) for _, m in metrics_all for v in m.values()):
        raise AssertionError("a loss, penalty or count is not finite")
    if not all("r1_penalty" in m and "pl_penalty" in m for n_, m in metrics_all if n_ == "reg"):
        raise AssertionError("a reg step reported no R1 or path-length penalty")
    for name in ("main", "reg"):
        got, exp = per_phase[name], expected[name]
        want = dict(B4=SG2_STEPS * exp["B4"], B4bwd=SG2_STEPS * exp["B4bwd"],
                    B3=SG2_STEPS * sum(exp["B3"].values()),
                    B3_by_order={k: SG2_STEPS * v for k, v in exp["B3"].items()}, B1=0, B2=0)
        if got != want:
            raise AssertionError(f"sg2 {name} launches {got}, expected {want}")
    unchanged = [k for k, v in watch.items() if torch.equal(v, before[k])]
    if unchanged or pl_after_warmup == 0.0 or state.pl_mean.item() == 0.0:
        raise AssertionError(f"the sg2 steps left {unchanged} unchanged or pl_mean at 0 "
                             f"({pl_after_warmup}, {state.pl_mean.item()})")
    med = {k: statistics.median(v) for k, v in times.items()}
    blend = 0.75 * med["main"] + 0.25 * med["reg"]
    canvas = 2 * (res + 2 * (math.ceil(res / 4) + 6))
    flops = {k: sg2_flops(g, d, canvas, mb, reg=(k == "reg")) for k in med}
    log(f"sg2 launches per step (asserted, derived from the model): main B3 "
        f"{sum(expected['main']['B3'].values())} {expected['main']['B3']} by order, B4 "
        f"{expected['main']['B4']}, B4 backward {expected['main']['B4bwd']}; reg B3 "
        f"{sum(expected['reg']['B3'].values())} {expected['reg']['B3']}, B4 "
        f"{expected['reg']['B4']}, B4 backward {expected['reg']['B4bwd']}; B1 and B2 none")
    log("sg2 checks: losses, r1_penalty and pl_penalty finite; G, mapping, D and EMA weights "
        f"and w_avg changed; pl_mean {state.pl_mean.item():.5f}")
    for k in ("main", "reg"):
        log(f"sg2 {k} step {res}^2 mb {mb}: {1e3 * med[k]:.2f} ms/step (median of "
            f"{len(times[k])}; range {1e3 * min(times[k]):.2f}-{1e3 * max(times[k]):.2f}); "
            f"{flops[k] / 1e12:.3f} TFLOP per step from the shapes, "
            f"{flops[k] / med[k] / 1e12:.1f} TFLOP/s")
    log(f"sg2 blend 0.75 main + 0.25 reg: {1e3 * blend:.2f} ms -> {blend / mb * 1000:.2f} "
        f"s/kimg, {mb / blend:.2f} img/s; peak memory {peak:.2f} GiB")
    if profile:
        for name in ("main", "reg"):
            phase_profile(f"one sg2 {name} step at microbatch {mb}",
                          lambda: steps[name](state, batch, gen))
    return dict(launches=launches, per_phase=per_phase, ms=med, s_per_kimg=blend / mb * 1000)


def phase_sg2_train_parity(device) -> None:
    """A main and a reg step of a toy model on the card and on the CPU, f32,
    from the same weights, batch and draws, ADA pinned by debug_percentile."""
    tcfg = SG2TrainConfig(glr=0.0, adam_eps=1e-3)
    cfg, g0, d0 = build_sg2(SG2_PARITY_MODEL, "cpu", seed=23)
    gen = torch.Generator().manual_seed(24)
    mb, res = SG2_PARITY_MB, cfg.img_resolution
    batch = dict(x=torch.rand((mb, 3, res, res), generator=gen) * 2 - 1,
                 h=torch.randn((mb, cfg.h_dim), generator=gen),
                 gen_h=torch.randn((mb, cfg.h_dim), generator=gen))
    num_ws = g0.mapping.num_ws
    draws = dict(z=torch.randn((mb, cfg.z_dim), generator=gen),
                 z_d=torch.randn((mb, cfg.z_dim), generator=gen),
                 cutoffs=torch.tensor([3, num_ws]),
                 z2s=torch.randn((2, mb, cfg.z_dim), generator=gen),
                 pl_noise=torch.randn((mb // 2, 3, res, res), generator=gen))
    pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")

    def aug(img, p, generator):
        return pipe(img, p, generator, debug_percentile=0.3)

    worst = {}
    for reg in (False, True):
        out = {}
        for label, dev in (("cpu", "cpu"), ("card", device)):
            g = sg2.Generator(cfg, device=dev)
            d = sg2.Discriminator(cfg, device=dev)
            g.load_state_dict(g0.state_dict())
            d.load_state_dict(d0.state_dict())
            state = SG2TrainState.create(g, d, tcfg)
            step = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg, augment_fn=aug,
                                       debug_grads=True)
            before = counts()
            _, m = step(state, {k: v.to(dev) for k, v in batch.items()},
                        torch.Generator(device=dev).manual_seed(0),
                        draws={k: v.to(dev) for k, v in draws.items()})
            if dev != "cpu" and any(counts()[k] == before[k] for k in ("B3", "B4", "B4bwd")):
                raise AssertionError("the card's sg2 step did not launch B3 and both B4 kernels")
            out[label] = (m, state)
        (mc, sc), (mg, sg) = out["cpu"], out["card"]
        tag = "reg" if reg else "main"
        for k in [k for k in mc if k not in ("g_grads", "d_grads")]:
            a, b = mg[k].item(), mc[k].item()
            rel = abs(a - b) / max(abs(b), 1e-6)
            if not (rel <= 1e-4 or (b == 0.0 and a == 0.0)):
                raise AssertionError(f"sg2 parity {tag} {k}: card {a} CPU {b}")
            worst[f"{tag} losses"] = max(worst.get(f"{tag} losses", 0.0), rel)
        for which in ("g_grads", "d_grads"):
            rel = 0.0
            for k, r in mc[which].items():
                if k.endswith("noise_strength"):
                    continue
                err = (mg[which][k].cpu() - r).abs().max().item()
                rmax = r.abs().max().item()
                if not err <= 1e-2 * rmax + 1e-12:
                    raise AssertionError(f"sg2 parity {tag} {which} {k}: max|Δ| {err} "
                                         f"(max|ref| {rmax})")
                rel = max(rel, err / max(rmax, 1e-12))
            worst[f"{tag} {which}"] = rel
        for name, a, b in (("w_avg", sg.g.mapping.w_avg.cpu(), sc.g.mapping.w_avg),
                           ("pl_mean", sg.pl_mean.cpu(), sc.pl_mean)):
            err = (a - b).abs().max().item()
            if not err <= 1e-3 * max(b.abs().max().item(), 1e-12):
                raise AssertionError(f"sg2 parity {tag} {name}: max|Δ| {err}")
            worst[f"{tag} {name}"] = err / max(b.abs().max().item(), 1e-12)
    log(f"sg2 train-step parity ({res}^2, mb {mb}, f32, ADA 'bgc' fast at debug_percentile "
        f"0.3, card against CPU): worst relative |Δ|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + " (bars: losses 1e-4, grads 1e-2 of the tensor's max, w_avg/pl_mean 1e-3)")


class CardDataset:
    """``SG2_LOOP_IMAGES`` images in [-1, 1] and unit instance features drawn
    from a seed on the card, behind the two methods the trainer calls on an
    ``HDF5Dataset`` (``sample_batch``, ``sample_conditioning_instance_balance``);
    indices from a CPU generator."""

    def __init__(self, res, h_dim, device, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.images = torch.rand((SG2_LOOP_IMAGES, 3, res, res), generator=gen,
                                 device=device) * 2 - 1
        self.feats = F.normalize(torch.randn((SG2_LOOP_IMAGES, h_dim), generator=gen,
                                             device=device), dim=1)
        self.index = torch.Generator().manual_seed(seed)

    def _draw(self, n):
        return torch.randint(0, SG2_LOOP_IMAGES, (n,), generator=self.index).to(
            self.images.device)

    def sample_batch(self, n):
        i = self._draw(n)
        return Batch(self.images[i], None, self.feats[self._draw(n)], None)

    def sample_conditioning_instance_balance(self, n):
        return None, self.feats[self._draw(n)]


def _state_tensors(state) -> dict:
    """Every tensor and count of an SG2TrainState by a flat name."""
    out = {}
    for key in ("g", "d", "g_ema", "g_opt", "d_opt"):
        sd = getattr(state, key).state_dict()
        if key.endswith("_opt"):
            sd = {f"{i}.{k}": t for i, st in sd["state"].items() for k, t in st.items()}
        out.update({f"{key}.{k}": t for k, t in sd.items()})
    for key in ("pl_mean", "ada_p", "ada_sign_sum", "ada_count", "step", "cur_nimg"):
        out[key] = getattr(state, key)
    return out


def phase_sg2_loop(device) -> dict:
    """The StyleGAN2-ADA training loop (``SG2Trainer.run``) at phase 10's
    model: every variant launches B3 and both B4 kernels, main and pl+r1 as
    many times as phase 10 derives; the tick records; the snapshot reloads
    bit for bit and the next step from it agrees with the live one; the EMA
    G behind ``make_sampler`` with truncation and constant noise."""
    shutil.rmtree(SG2_LOOP_DIR, ignore_errors=True)
    cfg = sg2.StyleGAN2Config(**SG2_MODEL)
    tcfg = SG2TrainConfig(**SG2_LOOP_TRAIN)
    lcfg = sg2_loop.SG2LoopConfig(
        experiment_name="sg2_loop", run_dir=SG2_LOOP_DIR, batch_size=SG2_MB,
        kimg_per_tick=SG2_LOOP_TICK_KIMG, snapshot_ticks=1, augment_spec="bgc",
        augment_p_init=SG2_P, seed=31)
    dataset = CardDataset(cfg.img_resolution, cfg.h_dim, device, seed=32)
    t0 = time.perf_counter()
    tr = sg2_loop.SG2Trainer(cfg, tcfg, lcfg, dataset, device=device)
    expected = sg2_expected_launches(tr.g, tr.d)
    sync()
    log(f"sg2 loop: SG2Trainer at {cfg.img_resolution}^2 (h_dim {cfg.h_dim}, channel_base "
        f"{cfg.channel_base}), microbatch {SG2_MB}, 'bgc' ADA from p {SG2_P}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    per_step, updates, saves = [], [], []

    def counting(key, fn):
        def step(state, batch, generator):
            c0 = dict(counts(), by_order=dict(rs.row_shift_fwd.launches_by_order))
            out = fn(state, batch, generator)
            c1 = dict(counts(), by_order=dict(rs.row_shift_fwd.launches_by_order))
            per_step.append((key, {k: c1[k] - c0[k] for k in ("B1", "B2", "B3", "B4", "B4bwd")},
                             {k: v - c0["by_order"].get(k, 0) for k, v in c1["by_order"].items()
                              if v != c0["by_order"].get(k, 0)}))
            return out
        return step

    real_update, real_save = sg2_loop.ada_update, sg2_loop.save_checkpoint

    def ada_update(state, cfg_, batch_size):
        before = (state.ada_p.item(), state.ada_sign_sum.item(), state.ada_count.item())
        state = real_update(state, cfg_, batch_size)
        updates.append((state.step, *before, state.ada_p.item()))
        return state

    def save_checkpoint(*args, **kw):
        sync()
        t1 = time.perf_counter()
        path = real_save(*args, **kw)
        saves.append(time.perf_counter() - t1)
        return path

    tr.steps = {k: counting(k, fn) for k, fn in tr.steps.items()}
    sg2_loop.ada_update, sg2_loop.save_checkpoint = ada_update, save_checkpoint
    try:
        reset_counts()
        t0 = time.perf_counter()
        tr.run(max_steps=SG2_LOOP_STEPS)
        sync()
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        sg2_loop.ada_update, sg2_loop.save_checkpoint = real_update, real_save

    # Every variant ran and launched B3 and both B4 kernels; main and pl+r1
    # exactly as phase 10 derives.
    names = {(False, False): "main", (True, False): "main+pl", (False, True): "main+r1",
             (True, True): "main+pl+r1"}
    by_variant = {}
    for key, got, by_order in per_step:
        by_variant.setdefault(names[key], (got, by_order))
        if min(got["B3"], got["B4"], got["B4bwd"]) == 0 or got["B1"] or got["B2"]:
            raise AssertionError(f"sg2 loop {names[key]} step launched {got}")
    if [names[k] for k, _, _ in per_step] != ["main+pl+r1", "main", "main+pl", "main+r1",
                                              "main+pl", "main", "main+pl+r1"]:
        raise AssertionError(f"sg2 loop variants {[names[k] for k, _, _ in per_step]}")
    for variant, exp in (("main", expected["main"]), ("main+pl+r1", expected["reg"])):
        got, by_order = by_variant[variant]
        want = (dict(B1=0, B2=0, B3=sum(exp["B3"].values()), B4=exp["B4"], B4bwd=exp["B4bwd"]),
                exp["B3"])
        if (got, by_order) != want:
            raise AssertionError(f"sg2 loop {variant} launches {got} {by_order}, phase 10 "
                                 f"derives {want}")
    # ADA's controller: p moved by sign(mean sign - target)·32/500 every 2 steps.
    adjust = SG2_MB * tcfg.ada_interval / (tcfg.ada_kimg * 1000)
    for step, p0, sign_sum, count, p1 in updates:
        mean = sign_sum / max(count, 1.0)
        want = max(p0 + math.copysign(adjust, mean - tcfg.ada_target)
                   if mean != tcfg.ada_target else p0, 0.0)
        if abs(p1 - want) > 1e-6:
            raise AssertionError(f"ada_update at step {step}: p {p0} -> {p1}, expected {want}")
    if [u[0] for u in updates] != [2, 4, 6]:
        raise AssertionError(f"ada_update ran after steps {[u[0] for u in updates]}")
    with open(os.path.join(tr.run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    p_at = {u[0]: u[4] for u in updates}
    want_p = [p_at[2], p_at[4], p_at[6], p_at[6]]
    if ([r["kimg"] for r in ticks] != [SG2_MB * k / 1000 for k in (2, 4, 6, 7)]
            or not all(math.isfinite(r["sec_per_kimg"]) and r["sec_per_kimg"] > 0 for r in ticks)
            or any(abs(r["augment_p"] - p) > 1e-6 for r, p in zip(ticks, want_p))
            or not all(math.isfinite(v) for r in ticks for v in r.values())):
        raise AssertionError(f"sg2 loop tick records {ticks}")
    if len(saves) != 4:
        raise AssertionError(f"sg2 loop saved {len(saves)} snapshots, expected 4 (one a tick)")

    # The snapshot into a fresh trainer (other seed), bit for bit.
    snap = os.path.join(tr.run_dir, "network-snapshot")
    size = sum(os.path.getsize(os.path.join(snap, n)) for n in os.listdir(snap))
    fresh = sg2_loop.SG2Trainer(cfg, tcfg, dataclasses.replace(
        lcfg, seed=33, experiment_name="sg2_loop_fresh"), dataset, device=device)
    sync()
    t1 = time.perf_counter()
    load_checkpoint(tr.run_dir, "network-snapshot", fresh.state)
    sync()
    load_s = time.perf_counter() - t1
    live, back = _state_tensors(tr.state), _state_tensors(fresh.state)
    diff = [k for k, v in live.items()
            if not (torch.equal(v, back[k]) if torch.is_tensor(v) else v == back[k])]
    if set(live) != set(back) or diff:
        raise AssertionError(f"sg2 snapshot reload differs in {diff[:5]}")
    # One more step from each, same batch and the live run's (seed, step)
    # generator: phase 8's bars, losses 1e-4 relative, state (w_avg,
    # pl_mean, ADA's sums) 1e-3 of its largest entry.  The updated weights
    # are logged, not held: two steps from one state need not agree bit for
    # bit on the card, and Adam turns a rounding difference in a gradient
    # near 0 into a step difference of the order of the learning rate (with
    # cuDNN's default algorithms the losses were 1.2e-4 apart, relative;
    # with its deterministic ones, used here, the losses agreed and a bias
    # of D, all its entries near 0, moved by up to 1.1e-2 of its largest
    # entry).  The reload itself is held bit for bit above.
    step_no = tr.state.step
    key = (step_no % tcfg.G_reg_interval == 0, step_no % tcfg.D_reg_interval == 0)
    batch = tr.make_batch()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, m_live = tr.steps[key](tr.state, batch, tr.step_generator(step_no))
        _, m_back = fresh.steps[key](fresh.state, batch, tr.step_generator(step_no))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    pairs = {k: (m_live[k].item(), m_back[k].item()) for k in m_live}
    worst_loss = max(abs(a - b) / max(abs(a), 1e-6) for a, b in pairs.values())
    if worst_loss > 1e-4:
        raise AssertionError(f"sg2 step after reload: losses differ by {worst_loss:.3e}: {pairs}")
    live, back = _state_tensors(tr.state), _state_tensors(fresh.state)
    state_keys = ("g.mapping.w_avg", "g_ema.mapping.w_avg", "pl_mean", "ada_p",
                  "ada_sign_sum", "ada_count")
    worst = dict(state=0.0, weights=0.0)
    for k in [k for k in live if k.startswith(("g.", "d.", "g_ema.")) or k in state_keys]:
        a, b = live[k].float(), back[k].float()
        err = (a - b).abs().max().item()
        scale = max(a.abs().max().item(), 1e-12)
        kind = "state" if k in state_keys else "weights"
        if kind == "state" and err > PARITY_STATE_REL * scale:
            raise AssertionError(f"sg2 step after reload: {k} max|Δ| {err:.3e} ({scale:.3e})")
        worst[kind] = max(worst[kind], err / scale)
    del fresh

    # The EMA G behind the sampler: a request of 20 in batches of 16 (the
    # tail padded) against direct calls on the same inputs.
    g_ema = tr.state.g_ema
    gen = torch.Generator(device=device).manual_seed(34)
    z = torch.randn((20, cfg.z_dim), generator=gen, device=device)
    h = dataset.sample_conditioning_instance_balance(20)[1]
    sampler = make_sampler(g_ema, batch_size=SG2_MB, device=device, truncation_psi=0.7,
                           noise_mode="const")
    reset_counts()
    got = sampler(z, None, h, device_output=True)
    sampler_b4 = counts()["B4"]
    with torch.no_grad():
        direct = torch.cat([g_ema(z[lo:lo + n], None, h[lo:lo + n], truncation_psi=0.7,
                                  noise_mode="const") for lo, n in ((0, 16), (16, 4))])
    sync()
    direct = direct.permute(0, 2, 3, 1)
    if got.shape != (20, cfg.img_resolution, cfg.img_resolution, 3) or sampler_b4 == 0:
        raise AssertionError(f"sg2 sampler gave {tuple(got.shape)}, B4 launches {sampler_b4}")
    # bf16 in the top resolutions: the padded tail's batch of 16 may take
    # other convolution algorithms than the direct batch of 4.
    dev_ = (got - direct).abs()
    if not bool((dev_ <= BF16_TOL["atol"] + BF16_TOL["rtol"] * direct.abs()).all()):
        raise AssertionError(f"sg2 sampler: max|sampler - direct| {dev_.max().item():.3e}")
    same_batch = torch.equal(got[:16], direct[:16])
    shutil.rmtree(SG2_LOOP_DIR, ignore_errors=True)

    # A tick's time holds the snapshot saved at the tick before it (snapshot_ticks
    # 1): the loop's own s/kimg is that less the save.
    net = [(r["sec_per_kimg"] * (r["kimg"] - prev["kimg"]) - save) / (r["kimg"] - prev["kimg"])
           for prev, r, save in zip(ticks, ticks[1:], saves)]
    log("sg2 loop variants and launches per step: " + "; ".join(
        f"{v} B3 {g['B3']} {o} B4 {g['B4']} B4 backward {g['B4bwd']}"
        for v, (g, o) in by_variant.items()) + " (main and main+pl+r1 as phase 10 derives)")
    log(f"sg2 loop {SG2_LOOP_STEPS} steps in {wall:.2f} s; ticks (kimg, s/kimg, augment_p): "
        + ", ".join(f"({r['kimg']}, {r['sec_per_kimg']:.3f}, {r['augment_p']:.4f})"
                    for r in ticks)
        + f"; less the snapshot saved in ticks 1-3: "
        + ", ".join(f"{v:.3f}" for v in net) + " s/kimg"
        + "; ada_update after steps 2, 4, 6 as its rule gives")
    log(f"sg2 loop snapshot: {size / 2 ** 20:.1f} MiB; save {1e3 * statistics.median(saves):.0f} "
        f"ms (median of {len(saves)}), load {1e3 * load_s:.0f} ms; reload bit for bit in "
        f"{len(live)} tensors and counts; the next step from it against the live one's "
        f"(cuDNN deterministic): worst relative |Δ| losses {worst_loss:.3e}, state "
        f"{worst['state']:.3e} (bars 1e-4, {PARITY_STATE_REL:g}); weights after Adam "
        f"{worst['weights']:.3e} of a tensor's largest entry (logged)")
    log(f"sg2 sampler: make_sampler(g_ema, batch_size {SG2_MB}, truncation_psi 0.7, "
        f"noise_mode const) for 20 images against direct calls: max|Δ| full batch "
        f"{dev_[:16].max().item():.3e} (bit for bit: {same_batch}), padded tail "
        f"{dev_[16:].max().item():.3e}; bar atol {BF16_TOL['atol']} + rtol {BF16_TOL['rtol']}")
    return dict(launches=launches, by_variant=by_variant, ticks=ticks, net_s_per_kimg=net,
                snapshot_mib=size / 2 ** 20, save_ms=1e3 * statistics.median(saves),
                load_ms=1e3 * load_s)


def main(argv) -> int:
    card = phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    tensor_cores = phase_tensor_cores()
    max_err = phase_kernels()
    sg2_err = phase_b3_b4()
    timings = phase_timings()
    bwd_timings = phase_bwd_timings()
    sg2_timings = phase_b3_b4_timings()
    main_run = phase_main_path(device)
    if "--profile" in argv:
        z, feats = main_run["requests"][0]
        phase_profile(f"one sampler batch of {SAMPLER_BATCH}",
                      lambda: main_run["sampler"](z, feats=feats, device_output=True))
    phase_parity(main_run, device)
    del main_run["g"], main_run["sampler"], main_run["requests"]
    torch.cuda.empty_cache()
    train = phase_train(device, "--profile" in argv)
    phase_train_parity(device)
    torch.cuda.empty_cache()
    sg2_run = phase_sg2_train(device, "--profile" in argv)
    torch.cuda.empty_cache()
    phase_sg2_train_parity(device)
    torch.cuda.empty_cache()
    loop = phase_sg2_loop(device)
    b2 = bwd_timings["G"]
    by_path = lambda sampler, train_, sg2_train, sg2_loop_=0: dict(  # noqa: E731
        sampler=sampler, train=train_, sg2_train=sg2_train, sg2_loop=sg2_loop_)
    per_loop_step = lambda k: {v: g[k] for v, (g, _) in loop["by_variant"].items()}  # noqa: E731
    b3, b3a = sg2_timings["B3"], sg2_timings["B3_adjoint"]
    b4, b4b = sg2_timings["B4"], sg2_timings["B4bwd"]
    b1 = timings["sampler"]
    kernels = [dict(
        name="sagan_attention_fwd", route="cuda",
        source="ic_gan_tpu_torch/csrc/sagan_attention_fwd.cu",
        replaces="ic_gan_tpu/ops/pallas/attention.py:56",
        launches=main_run["launches"] + train["fwd"],
        launches_by_path=by_path(main_run["launches"], train["fwd"], 0),
        max_abs_err=max_err["fwd"],
        ms=b1["kernel_ms"], plain_ms=b1["plain_ms"],
        bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
        library_ms=b1["library_ms"], tflops=b1["tflops"], of_bound=b1["of_bound"],
        tensor_core_instructions={k: v for k, v in tensor_cores.items() if "fwd" in k},
        train_shapes=dict(G=timings["G"], D=timings["D"]),
    ), dict(
        name="sagan_attention_bwd", route="cuda",
        source="ic_gan_tpu_torch/csrc/sagan_attention_bwd.cu",
        replaces="ic_gan_tpu/ops/pallas/attention.py:136",
        launches=train["bwd"],
        launches_by_path=by_path(0, train["bwd"], 0),
        max_abs_err=max_err["bwd"],
        ms=b2["kernel_ms"], plain_ms=b2["plain_ms"],
        bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
        library_ms=b2["library_ms"], tflops=b2["tflops"], of_bound=b2["of_bound"],
        tensor_core_instructions={k: v for k, v in tensor_cores.items() if "bwd" in k},
        train_shapes=bwd_timings,
    ), dict(
        name="row_shift", route="cuda", source="ic_gan_tpu_torch/csrc/row_shift.cu",
        replaces="ic_gan_tpu/ops/pallas/row_shift.py:104",
        launches=sg2_run["launches"]["B3"] + loop["launches"]["B3"],
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B3"], loop["launches"]["B3"]),
        launches_per_step={k: {o: n // SG2_STEPS for o, n in v["B3_by_order"].items()}
                           for k, v in sg2_run["per_phase"].items()},
        launches_per_loop_step={v: o for v, (_, o) in loop["by_variant"].items()},
        max_abs_err=sg2_err["B3"], ms=b3["kernel_ms"], plain_ms=b3["plain_ms"],
        bound_ms=b3["bound_ms"], bound_by=b3["bound_by"], library_ms=b3["library_ms"],
        of_bound=b3["of_bound"], adjoint=dict(
            shape=[B3_PATH[0], B3_PATH[2], B3_PATH[1]], ms=b3a["kernel_ms"],
            plain_ms=b3a["plain_ms"], bound_ms=b3a["bound_ms"], library_ms=b3a["library_ms"]),
    ), dict(
        name="bias_act", route="cuda", source="ic_gan_tpu_torch/csrc/bias_act.cu",
        replaces="ic_gan_tpu/ops/pallas/bias_act.py:103",
        launches=sg2_run["launches"]["B4"] + loop["launches"]["B4"],
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B4"], loop["launches"]["B4"]),
        launches_per_step={k: v["B4"] // SG2_STEPS for k, v in sg2_run["per_phase"].items()},
        launches_per_loop_step=per_loop_step("B4"),
        max_abs_err=sg2_err["B4"], ms=b4["kernel_ms"], plain_ms=b4["plain_ms"],
        bound_ms=b4["bound_ms"], bound_by=b4["bound_by"], library_ms=None,
        of_bound=b4["of_bound"],
    ), dict(
        name="bias_act_bwd", route="cuda", source="ic_gan_tpu_torch/csrc/bias_act.cu",
        replaces="ic_gan_tpu/ops/pallas/bias_act.py:92 (the custom_jvp tangent of _forward)",
        launches=sg2_run["launches"]["B4bwd"] + loop["launches"]["B4bwd"],
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B4bwd"], loop["launches"]["B4bwd"]),
        launches_per_step={k: v["B4bwd"] // SG2_STEPS for k, v in sg2_run["per_phase"].items()},
        launches_per_loop_step=per_loop_step("B4bwd"),
        max_abs_err=sg2_err["B4bwd"], ms=b4b["kernel_ms"], plain_ms=b4b["plain_ms"],
        bound_ms=b4b["bound_ms"], bound_by=b4b["bound_by"], library_ms=None,
        of_bound=b4b["of_bound"],
    )]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
