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
   same weights and z on the card and on the CPU; then the same with class
   conditioning (cc_icgan, 10 classes) and DiffAugment, the augmentation
   draws the same on both sides;
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
   save and load time), the CLI's snapshot eval (FID and IS of 256 EMA
   images, the best snapshot kept), a bit-for-bit reload into a fresh
   trainer and one more step from it against the live one; then
   ``make_sampler`` over the EMA G with ``truncation_psi`` 0.7 and constant
   noise against direct calls;
13. the BigGAN training loop: ``Trainer.run`` for 2 epochs of 3 steps at
   phase 7's model with upstream's cc_icgan heads (1000 classes, 2048-d
   features) and DiffAugment, from an in-memory dataset drawn on the card;
   B1 and B2 launch 4 and 3 times in every step; img/s of each epoch, the
   snapshot (size, save and load time), the eval after the second epoch
   (``make_train_eval_fn``, 1,024 images: FID and IS in the test log, the
   best copy saved), a bit-for-bit reload (the live history, less what the
   eval writes after the snapshot, and the live dataset RNG, which the eval
   leaves alone) and one more step from it against the live one;
   ``make_sampler`` over the folded bf16 EMA G with labels and features
   against direct calls;
14. the eval path: InceptionV3 on the card against the JAX package's golden
   outputs (``tests/golden/inception_golden.npz``), against the CPU in f32
   and against its own f32 in the bf16 mode, and timed alone in NCHW and
   channels-last; the FID tail (``fid_is_device``) against float64 on the
   host at full rank and rank-deficient; then ``evaluate_generator`` over
   ``make_fused_feature_fn`` of phase 5's sampler for 10,000 images at batch
   128, Inception in f32 and in bf16: img/s, the tail's time, peak memory,
   B1's launches (one a batch), the FID recomputed in float64 on the host,
   and the FID between the two Inception modes.

15. BigGAN-deep at its published 256² geometry (ch 128, depth 2, 1000
   classes, attention at 64² in G and D: d 64, dv 256), weights from a seed:
   B1 and B2 against their plain versions at its three shapes (the sampler
   at batch 128, the train step's G at 32 and D at 64), bf16 and f32, and
   timed; the σ-folded bf16 sampler answering requests of 128, 200 and 1
   (img/s, peak memory, phase 6's parity); the bf16 train step at
   microbatch 32 (ms/step, img/s, peak memory, B1/B2 launches held to the
   counts its attention layers give); phase 8's parity on a toy deep model;
   ``Trainer.run`` for 2 steps with a save and a bit-for-bit reload;
16. the inference entry points: ``cli/generate_images.py`` from a native
   checkpoint of phase 5's IC-GAN G (a best copy, as ``Trainer`` names it)
   and 1,000 stored instances, against ``make_sampler`` on the same draws;
   an upstream ``.pth`` bundle of phase 15's deep G through
   ``load_generator`` and ``load_model_inference``, against phase 15's
   sampler; ``cli/demo.py`` with a ResNet-50 from a seed, its ranking against
   the cosine similarities the same network gives, and ResNet-50's time at
   batch 16; ``make_conditioned_sampler`` over an in-memory dataset in both
   balance modes.  B1 is counted on each path;
17. data preparation and the eval CLIs: ``prepare_data``'s cores on the
   card (10,000 images at 256² through ResNet-50 with the flip bank, the
   first batch against direct calls bit for bit; the exact k-NN and 100
   Lloyd iterations of k-means with K 1000 over a 115,846 × 2048 bank, the
   size of ImageNet-LT's training split, against float64 on the host; the
   FID moments of 5,000 of the images), then ``cli/test.py`` (phase 16's
   IC-GAN G, deploy_bf16, standing statistics, PRDC, a sample npz) and
   ``cli/calc_metrics.py`` (phase 12's StyleGAN2 model, FID, KID, PR, IS
   and PPL with LPIPS) over those images in memory (the card's machine has
   no ``h5py``), each against direct calls on the same draws, with
   img/s, seconds and peak memory; B1 counted on the first CLI's path, B4
   on the second's;
18. int8 serving and the exported sampler: phase 5's IC-GAN G and phase
   15's deep G as upstream ``.pth`` bundles and phase 12's StyleGAN2 model
   as a network snapshot, each through ``load_model_inference`` with and
   without ``quantize_serving`` (64 calibration images, features from a
   stored-features file; StyleGAN2 static per-channel and with
   ``quantize_dynamic``): img/s of the int8 and the float sampler in turns,
   the drift of the int8 images, peak memory, the calibration's seconds, B1
   or B4 launches, agreement with direct calls, and the IC-GAN G once with
   ``skip_attention=False``; each distinct int8 conv of that G, a StyleGAN2
   composite up=2 conv and the fused 1×1 attention conv through the int8
   route (im2col and ``torch._int_mm``) against its plain version bit for
   bit, timed against the bf16 cuDNN conv; then the bf16 and int8 IC-GAN G,
   the deep G and the int8 StyleGAN2 G exported (``export_sampler``) and
   loaded back: MiB, seconds, img/s and max|Δ| against the live sampler, and
   the kernels launched inside the loaded program;
19. the remaining CLIs and the pretrained-weight paths: ``cli/visualize.py``
   on phase 5's G from a ``.pth`` bundle (an 8 × 8 sample sheet from stored
   instances, the three interpolation sheets) and on phase 12's StyleGAN2 G
   (style_mixing.py's seed grid, a random sheet of 64), each against direct
   sampler calls bit for bit; ``project`` on phase 12's G toward one of its
   images for 200 steps (upstream 1,000) with LPIPS (VGG16 from a seed): ms a
   step, the loss,
   B4 forward and backward launches a step; CLIP ViT-B/32 from a seed over
   phase 5's G folded in f32, the search at the colab's population and
   augmentations as CMA-ES + terminal Adam and as Adam: ms and B1/B2
   launches an iteration, the tokenizer on a synthetic BPE table; a synthetic
   TFHub BigGAN-256 dump (attention at 128²) through ``load_tfhub_generator``
   behind the bf16 sampler at batch 128 (img/s, peak memory, B1 a batch,
   phase 6's parity) and ``cli/convert_tfhub.py``; a TF1 GraphDef over every
   op ``TFGraphExecutor`` handles through ``OfficialTF1Evaluator`` and
   ``cli/official_eval.py`` over 1,024 of phase 5's images (img/s, the
   ``fid_a``/``fid_b`` path, the card against the CPU executor); then
   ``plot_logs``' series of phases 12 and 13.  Phases 3 and 4 hold B1 at
   the TFHub shape and B1 and B2 in f32 at the search's, and time them at
   full N;
20. the batch loader and data parallelism: (a) ``data.loader.normalize_batch``
   on 1,024 uint8 256² images at batch 256, both formulas with and without
   the flip, bit for bit against the host formulas, and its img/s and bytes
   copied against the f32 path it replaced, beside phase 13's loop and
   phase 17's moments img/s (both read through it); (b) NCCL at world size
   1: phase 7's BigGAN in f32 and phase 10's StyleGAN2-ADA in f32 (a main
   and a reg step), each data-parallel against the plain step from the same
   state and draws at phases 8's and 11's bars, B1/B2 and B3/B4 counted,
   ms/step of both; the StyleGAN2 steps again at phase 10's bf16
   resolutions, the data-parallel and a second plain step each against the
   plain one, logged; (c) two processes on the one card over gloo at
   ``dryrun_multichip``'s toy geometry in f32 (attention in D, ADA 'bgc' on
   the fast geometry), the BigGAN and StyleGAN2-ADA legs against one rank on
   the global batch.

``--profile`` adds device-time breakdowns of one sampler batch, one BigGAN
train step, one StyleGAN2 main and reg step, one eval batch (G and
Inception, and Inception alone, in each mode), one BigGAN-deep sampler
batch and one BigGAN-deep train step, one bf16 and one int8 IC-GAN sampler
batch, one float and one int8 StyleGAN2 sampler batch, one batch of the
loaded int8 StyleGAN2 program, one TFHub sampler batch, 20 projector steps
and one CLIP-guided Adam iteration, with the kernels launched
inside ``BiasAct.backward`` (its ``bias_act_bwd`` range) summed apart.  The
last three lines of standard output are the card (name, power limit), one
JSON object describing each kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import copy
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
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.utils import skip_init

from ic_gan_tpu_torch.cli import plot_logs
from ic_gan_tpu_torch.data.ada import AugmentPipe
from ic_gan_tpu_torch.data import loader as data_loader
from ic_gan_tpu_torch.data.augment import augment_draws
from ic_gan_tpu_torch.cli import train_stylegan2 as sg2_cli
from ic_gan_tpu_torch.data.datasets import Batch
from ic_gan_tpu_torch.eval import pipeline as eval_pipeline
from ic_gan_tpu_torch.eval.fid import (
    fid_is_device,
    frechet_distance,
    full_f32,
    full_f32_matmul,
    inception_score,
    trace_sqrtm_product,
)
from ic_gan_tpu_torch.eval.pipeline import (
    InceptionEvaluator,
    evaluate_generator,
    make_fused_feature_fn,
    make_train_eval_fn,
    moments_filename,
)
from ic_gan_tpu_torch.io.checkpoint import load_checkpoint
from ic_gan_tpu_torch.io.deploy import cast_params, fold_spectral_norm, make_sampler
from ic_gan_tpu_torch.models import stylegan2 as sg2
from ic_gan_tpu_torch.models.biggan import BigGANConfig, Discriminator, Generator
from ic_gan_tpu_torch.models.biggan_deep import BigGANDeepConfig, model_classes
from ic_gan_tpu_torch.models.inception import InceptionV3
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
from ic_gan_tpu_torch.parallel.mesh import shard_batch
from ic_gan_tpu_torch.train.state import GANTrainState
from ic_gan_tpu_torch.train.step import TrainConfig, make_train_step
from ic_gan_tpu_torch.train import stylegan2_trainer as sg2_loop
from ic_gan_tpu_torch.train import trainer as biggan_loop
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
    # Phase 19's new shapes at N 2: the TFHub BigGAN-256's attention at 128²
    # (its plain version holds (N, 16384, 4096) f32 logits, 256 MiB a
    # sample), and the CLIP-guided search's f32 G.
    ("tfhub 128^2 bf16", (2, 16384, 4096, 24, 96), torch.bfloat16, 3e-2),
    ("search f32", (2, 4096, 1024, 48, 192), torch.float32, 2e-5),
]
# Phase 19's shapes at full N: the TFHub sampler at batch 128 (bf16, no
# log-sum-exp), the search's population of 50 in f32 (the forward without
# the log-sum-exp as its loss evaluation calls it, the backward as its
# gradient modes do).
TFHUB_ATTN = (128, 16384, 4096, 24, 96)
SEARCH_ATTN = (50, 4096, 1024, 48, 192)
PLAIN_CHUNK = 16     # the plain version over N in chunks: (128, 16384, 4096) f32 is 32 GiB
SHORT = {torch.bfloat16: "bf16", torch.float32: "f32"}

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
    ("search", (2, 4096, 1024, 48, 192)),
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
# The class-and-instance-conditioned (cc_icgan) step with DiffAugment: phase 8's
# model with 10 classes, the same augmentation draws on both sides.
PARITY_CLASSES = 10
DIFF_AUGMENT = "color,translation,cutout"
# The BigGAN training loop (phase 13): phase 7's model with upstream's
# cc_icgan_biggan_imagenet_res256 heads (class_cond, 1000 classes, 2048-d
# features), bf16 compute, phase 7's TrainConfig plus DiffAugment; 2 epochs of
# 3 steps, a save and one rotating copy every epoch, spectra every step.  The
# dataset (64 images, labels, unit features) is drawn on the card from a seed.
BIGGAN_LOOP_MODEL = dict(TRAIN_MODEL, class_cond=True, n_classes=1000)
BIGGAN_LOOP_EPOCHS, BIGGAN_LOOP_STEPS = 2, 3
BIGGAN_LOOP_IMAGES = 64
BIGGAN_LOOP_SAMPLES = 200
BIGGAN_LOOP_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_biggan_loop")

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

# --- the eval path (phase 14) -----------------------------------------------------
# The JAX package's eval bench (benchmarks/bench_eval_fid.py:35-140): 10,000
# images of phase 5's folded bf16 256² G at batch 128 through Inception at
# 299² (f32, then the bf16 deployment mode; random weights from a seed),
# then FID against synthetic reference moments and IS, on the card.
EVAL_IMAGES = 10000
EVAL_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                           "inception_golden.npz")
# The golden bars (tests/test_inception_graph.py:test_golden_outputs): pool
# atol 2e-4 + rtol 2e-3, logits atol 2e-3 + rtol 2e-3.  Card against CPU,
# f32: the pool within 1e-3 of its largest entry; the bf16 mode against the
# card's f32: JAX's drift bars (tests/test_metrics_and_tools.py:469-470), max
# 0.15 and mean 0.02 of the mean |pool|.
GOLDEN_POOL, GOLDEN_LOGITS = (2e-4, 2e-3), (2e-3, 2e-3)
INCEPTION_F32_REL, INCEPTION_BF16_MAX, INCEPTION_BF16_MEAN = 1e-3, 0.15, 0.02
INCEPTION_PARITY_IMAGES, INCEPTION_PARITY_RES = 8, 256
# The FID tail against float64 on the host: 10,000 pools (full rank,
# Newton-Schulz) and 512 (rank-deficient: its eigenvalue path), 1e-3 relative.
EVAL_TAIL_POOLS = (10000, 512)
EVAL_REL = 1e-3
# The loops' eval: reference moments from a seed under a data root of the
# build directory; 1,024 images for the BigGAN loop (phase 13), 256 for the
# StyleGAN2 loop (phase 12), as their CLIs build the eval.
EVAL_DATA_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_eval_data")
BIGGAN_LOOP_EVAL_IMAGES, SG2_LOOP_EVAL_IMAGES = 1024, 256
# What ``Trainer.test`` writes into the history after the snapshot.
EVAL_HISTORY_KEYS = ("best_IS", "best_FID", "save_best_num", "epochs_no_improvement")
DEV = "cuda"         # the kernel phases' device (the CPU only to rehearse them)

# --- BigGAN-deep (phase 15) ---------------------------------------------------------
# BigGAN-deep's published 256² geometry (Brock et al. 2019, arXiv:1809.11096,
# appendix B; BigGAN-PyTorch scripts/launch_BigGAN_deep.sh): ch 128, depth 2,
# dim_z 128, shared_dim 128, hier, 1000 classes, attention at 64² in G and D.
# Weights from a seed.  Its attention layers have 512 channels: d 64, dv 256.
DEEP_MODEL = dict(resolution=256, G_ch=128, D_ch=128, G_depth=2, D_depth=2, dim_z=128,
                  shared_dim=128, hier=True, n_classes=1000, G_attn="64", D_attn="64",
                  class_cond=True, instance_cond=False)
DEEP_SAMPLER_ATTN = (128, 4096, 1024, 64, 256)   # the sampler at batch 128
DEEP_G_ATTN = (32, 4096, 1024, 64, 256)          # the train step's G, microbatch 32
DEEP_D_ATTN = (64, 4096, 1024, 64, 256)          # its D on fake and real together
DEEP_MB = 32
DEEP_STEPS = 5
# Card against CPU, f32: a toy deep model, class-conditional (10 classes).
DEEP_PARITY_MODEL = dict(resolution=64, G_ch=16, D_ch=16, G_attn="32", D_attn="32",
                         n_classes=PARITY_CLASSES)
DEEP_LOOP_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_deep_loop")
DEEP_LOOP_STEPS = 2

# --- the inference entry points (phase 16) ------------------------------------------
# Phase 5's IC-GAN G as a flat config a user would pass (split_config's
# defaults differ from BigGANConfig's: hier, G_shared_feat, the widths).
INFERENCE_FLAT = dict(resolution=256, G_ch=96, D_ch=96, G_attn="64", D_attn="64", hier=True,
                      instance_cond=True, G_shared_feat=True, shared_dim=128,
                      shared_dim_feat=512, dim_z=120)
INFERENCE_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_inference")
INFERENCE_BATCH = 32               # load_model_inference's default batch
STORED_INSTANCES = 1000            # k-means centres of the stored-instances file
DEMO_SAMPLES = 16

# --- data preparation and the eval CLIs (phase 17) ------------------------------------------
# prepare_data's cores: 10,000 uint8 images at 256² through ResNet-50 (224²,
# the flip bank) at batch 128; the exact k-NN and k-means at the size of
# ImageNet-LT's training split (Liu et al. 2019, the split IC-GAN trains on):
# 115,846 × 2048 f32 rows, k 51 (k_nn 50 and the row itself), K 1000 in 100
# Lloyd iterations; each checked against float64 on the host, ties within
# 1e-4 left out; FID moments of the first 5,000 images.  Then both eval CLIs
# over those images in memory: cli/test.py on phase 16's IC-GAN G (1,024
# images, PRDC over 1,024 real ones, a 256-image npz) and cli/calc_metrics.py
# on phase 12's StyleGAN2 model (five metrics at 1,024 images, PPL at 512),
# each against direct calls on the same draws.  The image counts (moments
# 10,000, the CLIs 2,048) were halved to keep the phase near 90 s; the bank
# and K are full size.
PREP_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_prepare")
PREP_IMAGES, PREP_RES, PREP_BATCH = 10000, 256, 128
MOMENTS_IMAGES = 5000                    # the first half of the step-1 images
BANK_ROWS, BANK_CLUSTERS, BANK_K = 115846, 1000, 51
KNN_CHECK_ROWS, KNN_TOL = 256, 1e-4
KMEANS_K, KMEANS_ITERS, KMEANS_CHECK_ROWS, KMEANS_CHECK_CENTROIDS = 1000, 100, 4096, 64
TEST_CLI_IMAGES, TEST_CLI_BATCH, TEST_CLI_NPZ = 1024, 128, 256
CALC_IMAGES, CALC_BATCH, PPL_SAMPLES = 1024, 64, 512
CALC_METRICS = ("fid50k_full", "kid50k_full", "pr50k3_full", "is50k", "ppl2_wend")
CLI_REL = 1e-4       # a CLI's metrics against direct calls on the same draws


def log(msg: str):
    print(msg, flush=True)


CARD = ""            # the card's name and power limit, from phase 1


def log_card(msg: str):
    """``msg`` with the card's name and power limit."""
    log(f"{msg} [{CARD}]")


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


_ATTN_KERNEL = re.compile(r"(sagan_attention_fwd_(?:mma|kernel)|attn_bwd_(?:q_mma|kv_mma|q_pass|"
                          r"k_pass))I((?:Li\d+E)+)")


def attention_kernel_name(mangled: str) -> str:
    """``sagan_attention_fwd_mma<256>`` … from a mangled kernel name (the
    mangled name itself when it is not an attention kernel)."""
    m = _ATTN_KERNEL.search(mangled)
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>" if m else mangled


def ptxas_entries(text: str) -> dict:
    """{kernel: (registers a thread, spill store bytes)} from ``ptxas -v``."""
    out = {}
    for block in re.split(r"Compiling entry function '", text)[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[attention_kernel_name(name)] = (int(regs.group(1)) if regs else 0,
                                            int(spill.group(1)) if spill else 0)
    return out


def phase_build() -> dict:
    """Builds every source; logs each one's registers and spills, and each
    dv-256 attention instantiation's (the BigGAN-deep shapes' d 64, dv 256).
    Returns {kernel: (registers, spill bytes)} of those instantiations ({}
    when the libraries were built before)."""
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} of {len(_build.sources())} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    dv256 = {}
    for name, text in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers a "
            f"thread; {sum(1 for b in spills if b)} spill, at most {max(spills, default=0)} bytes")
        dv256.update({k: v for k, v in ptxas_entries(text).items()
                      if re.search(r"<(?:\d+,)?256>", k)})
    if dv256:
        log("  dv-256 attention instantiations (registers a thread, spill store bytes): "
            + ", ".join(f"{k} {r}/{b}" for k, (r, b) in sorted(dv256.items())))
    return dv256


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
    named = {attention_kernel_name(fn): n for fn, n in counts.items()}
    mma = {k: v for k, v in named.items() if "_mma" in k}
    log("tensor-core instructions (HMMA/HGMMA in SASS) of each bf16 instantiation: "
        + ", ".join(f"{k} {v}" for k, v in sorted(mma.items())))
    log("  f32 instantiations (CUDA cores): "
        + ", ".join(f"{k} {v}" for k, v in sorted(named.items()) if k not in mma))
    if not mma or min(mma.values()) == 0:
        raise AssertionError(f"a bf16 attention kernel has no tensor-core instruction: {mma}")
    return mma


def check_fwd(name, shape, dtype, atol) -> float:
    """The attention forward (and its log-sum-exp) against the plain version
    on the card; returns max |kernel - plain|."""
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
    del got, ref, lse, ref_lse, args
    torch.cuda.empty_cache()
    return err


def check_bwd(name, shape, dtype, twice: bool = False) -> float:
    """The attention backward against the plain version on the card, each
    gradient at BWD_F32_ATOL (f32) or BWD_BF16_TOL (bf16); with ``twice``
    also run again for the same bits.  Returns the largest max |Δ|."""
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
    if twice:
        # No atomics: the same inputs give the same bits.
        again = sagan_attention_bwd(*args, lse)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"attention bwd {name} {str(dtype)[6:]} run twice: bit-identical {same}")
        if not same:
            raise AssertionError("the attention backward is not deterministic")
        del again
    del got, ref, args
    torch.cuda.empty_cache()  # the plain version's (N, Lq, Lk) f32 temps
    return worst


def phase_kernels() -> dict:
    """Each case: max |kernel - plain| on the card.  Returns each kernel's
    error at its path's main bf16 shape."""
    errs = {name: check_fwd(name, shape, dtype, atol) for name, shape, dtype, atol in ATTN_CASES}
    bwd_err = None
    for name, shape in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            err = check_bwd(name, shape, dtype, twice=name == "G" and dtype == torch.bfloat16)
            if name == "G" and dtype == torch.bfloat16:
                bwd_err = err
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


def time_fwd(label, shape, with_lse, dtype=torch.bfloat16, plain_chunk=None) -> dict:
    """The forward at ``shape`` in ``dtype`` (with the log-sum-exp as
    training calls it, or without as a sampler does): kernel, plain version
    (over N in chunks of ``plain_chunk`` where it cannot hold all of N),
    SDPA (``scale=1.0``, one head) and the bound."""
    a = attention_inputs(shape, dtype)
    heads = [t.unsqueeze(1) for t in a]  # one head: SDPA's fused backends take 4-D only

    def plain():
        step = plain_chunk or shape[0]
        for i in range(0, shape[0], step):
            sagan_attention_ref(*(t[i:i + step] for t in a), return_lse=with_lse)

    ts = dict(kernel_ms=cuda_ms(lambda: sagan_attention_fwd(*a, return_lse=with_lse)),
              plain_ms=cuda_ms(plain, reps=3 if plain_chunk else 5, warmup=1 if plain_chunk else 2),
              library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0)))
    ts["bound_ms"], ts["bound_by"] = attention_bound_ms(shape, dtype)
    rates(ts, attention_flops(shape))
    chunked = f" (in chunks of {plain_chunk} samples)" if plain_chunk else ""
    log_card("attention {} {} {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}{}  "
             "library_ms {library_ms:.4f} (SDPA, 4-D)  bound_ms {bound_ms:.4f} ({bound_by})  "
             "{tflops:.1f} TFLOP/s, {of_bound:.3f} of bound".format(
                 SHORT[dtype], label, shape, chunked, **ts))
    del a, heads
    torch.cuda.empty_cache()
    return ts


def time_bwd(label, shape, dtype=torch.bfloat16) -> dict:
    """The backward at ``shape`` in ``dtype``: kernel, plain version of the
    same contract (with the forward's log-sum-exp), the library's backward
    and the bound."""
    args = attention_inputs(shape, dtype, with_do=True)
    _, lse = sagan_attention_fwd(*args[:3], return_lse=True)
    t = dict(kernel_ms=cuda_ms(lambda: sagan_attention_bwd(*args, lse)),
             plain_ms=cuda_ms(lambda: sagan_attention_bwd_ref(*args, lse=lse),
                              reps=3, warmup=1))
    torch.cuda.empty_cache()
    t["library_ms"] = sdpa_bwd_ms(args)
    t["bound_ms"], t["bound_by"] = attention_bwd_bound_ms(shape, dtype)
    rates(t, attention_bwd_flops(shape))
    log_card("attention bwd {} {} {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
             "library_ms {library_ms:.4f} (SDPA fwd+bwd less fwd)  bound_ms {bound_ms:.4f} "
             "({bound_by})  {tflops:.1f} TFLOP/s, {of_bound:.3f} of bound".format(
                 SHORT[dtype], label, shape, **t))
    del args, lse
    torch.cuda.empty_cache()
    return t


def phase_timings() -> dict:
    """The forward at the sampler's and the training step's shapes, bf16, as
    each path calls it (the sampler without the log-sum-exp, training with
    it); f32 at the sampler's shape."""
    t = {label: time_fwd(label, shape, with_lse) for label, shape, with_lse in (
        ("sampler", MAIN_ATTN, False), ("G", TRAIN_G_ATTN, True), ("D", TRAIN_D_ATTN, True))}
    t["tfhub sampler"] = time_fwd("tfhub sampler", TFHUB_ATTN, False, plain_chunk=PLAIN_CHUNK)
    t["search f32"] = time_fwd("search", SEARCH_ATTN, False, dtype=torch.float32)
    args32 = attention_inputs(MAIN_ATTN, torch.float32)
    f32 = dict(kernel_ms=cuda_ms(lambda: sagan_attention_fwd(*args32)),
               plain_ms=cuda_ms(lambda: sagan_attention_ref(*args32)))
    f32["bound_ms"], _ = attention_bound_ms(MAIN_ATTN, torch.float32)
    log("attention f32 {}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        "bound_ms {bound_ms:.4f} (FP32 CUDA-core peak)".format(MAIN_ATTN, **f32))
    return t


def phase_bwd_timings() -> dict:
    """The backward at the training shapes, bf16, and at the search's in f32."""
    t = {label: time_bwd(label, shape) for label, shape in (("G", TRAIN_G_ATTN),
                                                             ("D", TRAIN_D_ATTN))}
    t["search f32"] = time_bwd("search", SEARCH_ATTN, dtype=torch.float32)
    return t


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
                requests=requests, img_per_s=SAMPLER_BATCH / med)


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
    ("pooling and resize", ("pool", "upsample")),
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
    generator_parity(main["g"], main["weights"], device)


def generator_parity(g16, weights, device) -> dict:
    """Phase 6 for any folded bf16 generator ``g16`` and a copy of its folded
    f32 ``weights``: z, then features or labels as its config reads them."""
    cfg16 = g16.cfg
    cfg32 = cfg16.replace(dtype=torch.float32)
    g_cls = model_classes(cfg32)[0]
    gen = torch.Generator(device=device).manual_seed(2)
    z = torch.randn((PARITY_BATCH, cfg16.effective_dim_z), generator=gen, device=device)
    feats = labels = None
    if cfg16.instance_cond:
        feats = torch.randn((PARITY_BATCH, cfg16.instance_sz), generator=gen, device=device)
    if cfg16.class_cond:
        labels = torch.randint(0, cfg16.n_classes, (PARITY_BATCH,), generator=gen, device=device)
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731

    def folded_f32(dev, round_to_bf16=False):
        g = fold_spectral_norm(skip_init(g_cls, cfg32, device=dev))
        g.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        if round_to_bf16:
            cast_params(cast_params(g, torch.bfloat16), torch.float32)
        return g

    with torch.inference_mode():
        out16 = g16(z, labels, feats).cpu()
        out32 = folded_f32(device)(z, labels, feats).cpu()
        out_w = folded_f32(device, round_to_bf16=True)(z, labels, feats).cpu()
        ref = folded_f32("cpu")(cpu(z), cpu(labels), cpu(feats))
    d16 = (out16 - ref).abs()
    err16, mean16 = d16.max().item(), d16.mean().item()
    err32 = (out32 - ref).abs().max().item()
    err_w = (out_w - ref).abs().max().item()
    met = "2e-4" if err32 <= 2e-4 else f"{F32_BAR:g}"
    name = f"{type(g16).__module__.rsplit('.', 1)[-1]} " \
        f"{cfg16.resolution}^2 ch{cfg16.G_ch}"
    log(f"whole G parity (batch {PARITY_BATCH}, {name}, against CPU f32): card bf16 max|d| "
        f"{err16:.4e} mean|d| {mean16:.4e} (bars {BF16_MAX_BAR}, {BF16_MEAN_BAR}); card f32 "
        f"with bf16-rounded weights max|d| {err_w:.4e}; card f32 max|d| {err32:.4e} "
        f"(bar met: {met})")
    if not (torch.isfinite(ref).all() and err16 <= BF16_MAX_BAR
            and mean16 <= BF16_MEAN_BAR and err32 <= F32_BAR):
        raise AssertionError(f"whole-G parity failed: bf16 max {err16} mean {mean16}, "
                             f"f32 {err32}")
    return dict(bf16_max=err16, bf16_mean=mean16, f32_max=err32, rounded_weights_max=err_w)


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


def build_gan(model, dtype, device, seed, deep: bool = False):
    """G and D (BigGAN's, or with ``deep`` BigGAN-deep's) with the port's
    init from a seed, gamma 0.5."""
    cfg = (BigGANDeepConfig if deep else BigGANConfig)(**model, dtype=dtype)
    g_cls, d_cls = model_classes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = g_cls(cfg, device=device, generator=gen)
    d = d_cls(cfg, device=device, generator=gen)
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


@contextlib.contextmanager
def relu_trace(masks=None):
    """``F.relu`` replaced for the block: every call's input is recorded
    (on the CPU), and with ``masks``, the records of another run, call i
    keeps the entries where that run's input was positive in place of its
    own sign (its gradient is then that mask)."""
    calls = []
    real = F.relu

    def relu(x, inplace=False):
        i = len(calls)
        calls.append(x.detach().cpu())
        if masks is None:
            return real(x, inplace=inplace)
        return x * (masks[i] > 0).to(x.device, x.dtype)

    F.relu = relu
    try:
        yield calls
    finally:
        F.relu = real


def _worst_grad(m_test, m_ref, which):
    """(worst relative |Δ| over a network's gradients, its tensor, max|Δ|,
    max|ref|), each |Δ| relative to max(max|ref|, the floor's share of the
    network's largest gradient), as the bars read it."""
    top = max(v.abs().max().item() for v in m_ref[which].values())
    worst = (0.0, "", 0.0, 0.0)
    for k, r in m_ref[which].items():
        err = (m_test[which][k].cpu() - r).abs().max().item()
        rmax = r.abs().max().item()
        rel = err / max(rmax, PARITY_GRAD_FLOOR * top / PARITY_GRAD_REL)
        worst = max(worst, (rel, k, err, rmax))
    return worst


def phase_train_parity(device, cc: bool = False, deep: bool = False) -> None:
    """One train step from the same weights, batch and z on the card and on
    the CPU, f32 (TF32 off since phase 1): losses, raw gradients, SN and BN
    state.  With ``cc``, the class-and-instance-conditioned model and
    DiffAugment, its draws made once on the CPU and given to both sides;
    with ``deep``, a class-conditional BigGAN-deep.  Each ReLU input is
    recorded on both sides; the entries whose sign differs are counted, and
    the card's step runs once more with the CPU's ReLU signs in place of its
    own, to show what of the gradients' gap they make (logged, not gated)."""
    if deep:
        tcfg = TrainConfig(ema_start=0, adam_eps=1e-3, class_cond=True, instance_cond=False)
        model = DEEP_PARITY_MODEL
    else:
        tcfg = TrainConfig(ema_start=0, adam_eps=1e-3, class_cond=cc,
                           DiffAugment=DIFF_AUGMENT if cc else "")
        model = dict(PARITY_MODEL, class_cond=True, n_classes=PARITY_CLASSES) if cc \
            else PARITY_MODEL
    cfg, g_cpu, d_cpu = build_gan(model, torch.float32, "cpu", seed=5, deep=deep)
    gen = torch.Generator().manual_seed(6)
    res, mb = cfg.resolution, PARITY_MB
    batch = dict(x=torch.rand((1, mb, 3, res, res), generator=gen) * 2 - 1)
    if cfg.instance_cond:
        batch.update(feats=torch.randn((1, mb, cfg.instance_sz), generator=gen),
                     gen_feats=torch.randn((2, mb, cfg.instance_sz), generator=gen))
    zs = [torch.randn((mb, cfg.effective_dim_z), generator=gen) for _ in range(2)]
    aug = None
    if cfg.class_cond:
        batch["label"] = torch.randint(0, cfg.n_classes, (1, mb), generator=gen)
        batch["gen_label"] = torch.randint(0, cfg.n_classes, (2, mb), generator=gen)
    if cc:
        aug = [augment_draws(DIFF_AUGMENT, torch.empty((n, 3, res, res)), gen)
               for n in (2 * mb, mb)]
    g_cls, d_cls = model_classes(cfg)

    def run(dev, masks=None):
        g = skip_init(g_cls, cfg, device=dev)
        d = skip_init(d_cls, cfg, device=dev)
        g.load_state_dict(g_cpu.state_dict())
        d.load_state_dict(d_cpu.state_dict())
        state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
        before = sagan_attention_bwd.launches
        with relu_trace(masks) as relus:
            _, m = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True)(
                state, {k: v.to(dev) for k, v in batch.items()}, zs=[z.to(dev) for z in zs],
                aug_draws=aug)
        if dev != "cpu" and sagan_attention_bwd.launches == before:
            raise AssertionError("the card's step did not launch the attention backward")
        return m, g, d, relus

    m_cpu, g_c, d_c, relus_cpu = run("cpu")
    m_gpu, g_g, d_g, relus_gpu = run(device)
    worst = {}
    for k in ("D_loss_real", "D_loss_fake", "G_loss"):
        a, b = m_gpu[k].item(), m_cpu[k].item()
        worst[k] = abs(a - b) / max(abs(b), 1e-6)
        if not worst[k] <= 1e-4:
            raise AssertionError(f"train parity {k}: card {a} CPU {b}")
    for which in ("d_grads", "g_grads"):
        top = max(v.abs().max().item() for v in m_cpu[which].values())
        for k, r in m_cpu[which].items():
            err = (m_gpu[which][k].cpu() - r).abs().max().item()
            rmax = r.abs().max().item()
            if not err <= PARITY_GRAD_REL * rmax + PARITY_GRAD_FLOOR * top:
                raise AssertionError(f"train parity {which} {k}: max|Δ| {err} (max|ref| {rmax})")
        worst[which] = _worst_grad(m_gpu, m_cpu, which)[0]
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
    what = f"cc_icgan ({cfg.n_classes} classes) + DiffAugment '{DIFF_AUGMENT}', " if cc else ""
    if deep:
        what = f"BigGAN-deep (depth {cfg.G_depth}, {cfg.n_classes} classes), "
    log(f"train-step parity ({what}{res}^2 ch{cfg.G_ch} attention at 32, mb {mb}, f32, card "
        f"against CPU): worst relative |Δ|: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({n_state} SN/BN buffers; bars: losses 1e-4, grads {PARITY_GRAD_REL:g} of the "
        f"tensor's max + {PARITY_GRAD_FLOOR:g} of the network's, state {PARITY_STATE_REL:g})")

    # Where the gradients' gap comes from: ReLU inputs whose sign the two
    # sides' rounding decides differently, and the gap with those signs
    # taken from the CPU.
    if len(relus_gpu) != len(relus_cpu):
        raise AssertionError(
            f"{len(relus_gpu)} ReLU calls on the card, {len(relus_cpu)} on the CPU")
    flips = []
    for i, (a, b) in enumerate(zip(relus_gpu, relus_cpu)):
        differ = (a > 0) != (b > 0)
        if differ.any():
            flips.append(f"call {i} of {len(relus_cpu)} {tuple(b.shape)}: {int(differ.sum())} "
                         f"at |x| <= {b[differ].abs().max().item():.3e} "
                         f"(max|x| {b.abs().max().item():.3e})")
    m_masked = run(device, masks=relus_cpu)[0]
    for which in ("d_grads", "g_grads"):
        w, w_masked = _worst_grad(m_gpu, m_cpu, which), _worst_grad(m_masked, m_cpu, which)
        log(f"  {which}: worst {w[0]:.3e} in {w[1]} (max|Δ| {w[2]:.3e}, max|ref| {w[3]:.3e}); "
            f"with the CPU's ReLU signs on the card {w_masked[0]:.3e} in {w_masked[1]}")
    log(f"  ReLU inputs of another sign on the card than on the CPU: "
        + ("; ".join(flips) if flips else "none"))


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
    indices from a numpy stream, ``rng``, as an ``HDF5Dataset`` draws them."""

    def __init__(self, res, h_dim, device, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.images = torch.rand((SG2_LOOP_IMAGES, 3, res, res), generator=gen,
                                 device=device) * 2 - 1
        self.feats = F.normalize(torch.randn((SG2_LOOP_IMAGES, h_dim), generator=gen,
                                             device=device), dim=1)
        self.rng = np.random.default_rng(seed)

    def _draw(self, n):
        return torch.as_tensor(self.rng.integers(0, SG2_LOOP_IMAGES, n),
                               device=self.images.device)

    def sample_batch(self, n):
        i = self._draw(n)
        return Batch(self.images[i], None, self.feats[self._draw(n)], None)

    def sample_conditioning_instance_balance(self, n):
        return None, self.feats[self._draw(n)]

    # The conditioned sampler's surface (phase 16): its balance mode, and the
    # class-balanced draw, a class from ``rng`` with the features of one of
    # the images (which carry no labels).
    which_nn_balance = "instance_balance"

    def sample_conditioning_nnclass_balance(self, n, num_classes=1000):
        return self.rng.integers(0, num_classes, n), self.feats[self._draw(n)]


def _state_tensors(state) -> dict:
    """Every tensor and count of a train state (``SG2TrainState``,
    ``GANTrainState``) by a flat name."""
    out = {}
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        if isinstance(v, (torch.nn.Module, torch.optim.Optimizer)):
            sd = v.state_dict()
            if isinstance(v, torch.optim.Optimizer):
                sd = {f"{i}.{k}": t for i, st in sd["state"].items() for k, t in st.items()}
            out.update({f"{field.name}.{k}": t for k, t in sd.items()})
        else:
            out[field.name] = v
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
    evals, snapshots = [], []
    eval_fn = timed_calls(sg2_cli.make_eval_fn(dict(
        data_root=write_eval_moments(cfg.img_resolution), resolution=cfg.img_resolution,
        num_inception_images=SG2_LOOP_EVAL_IMAGES, eval_batch_size=SG2_LOOP_EVAL_IMAGES // 4),
        device), evals)
    t0 = time.perf_counter()
    tr = sg2_loop.SG2Trainer(cfg, tcfg, lcfg, dataset, eval_fn=eval_fn, device=device)
    tr._snapshot = timed_calls(tr._snapshot, snapshots)
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

    def save_checkpoint(root, name, *args, **kw):
        sync()
        t1 = time.perf_counter()
        path = real_save(root, name, *args, **kw)
        (saves if name == "network-snapshot" else best_saves).append(time.perf_counter() - t1)
        return path

    best_saves = []
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
    # The snapshot eval as the CLI builds it, after each snapshot: FID and IS
    # finite in the metric log, the best snapshot saved after the first.
    with open(os.path.join(tr.run_dir, "metric-fid.jsonl")) as f:
        results = [json.loads(line)["results"] for line in f]
    fids = [r["FID"] for r in results]
    improved = sum(f < min(fids[:i], default=math.inf) for i, f in enumerate(fids))
    eval_launches = {k: sum(e["launches"][k] for e in evals) for k in evals[0]["launches"]}
    if len(evals) != 4 or len(results) != 4 or len(best_saves) != improved \
            or not all(math.isfinite(r[k]) for r in results for k in ("FID", "IS_mean")) \
            or tr.best_fid != min(fids) or eval_launches["B4"] == 0 \
            or not os.path.isdir(os.path.join(tr.run_dir, "best-network-snapshot")):
        raise AssertionError(f"sg2 loop eval: {results}, {len(best_saves)} best saves, "
                             f"launches {eval_launches}")

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
    logs = plot_logs.stylegan2_series(tr.run_dir)         # phase 19 prints them
    shutil.rmtree(SG2_LOOP_DIR, ignore_errors=True)

    # A tick's time holds the snapshot of the tick before it (snapshot_ticks
    # 1): its save, eval and any best save.  The loop's own s/kimg is that
    # less the snapshot.
    net = [(r["sec_per_kimg"] * (r["kimg"] - prev["kimg"]) - snap["s"]) / (r["kimg"] - prev["kimg"])
           for prev, r, snap in zip(ticks, ticks[1:], snapshots)]
    log("sg2 loop variants and launches per step: " + "; ".join(
        f"{v} B3 {g['B3']} {o} B4 {g['B4']} B4 backward {g['B4bwd']}"
        for v, (g, o) in by_variant.items()) + " (main and main+pl+r1 as phase 10 derives)")
    log(f"sg2 loop {SG2_LOOP_STEPS} steps in {wall:.2f} s; ticks (kimg, s/kimg, augment_p): "
        + ", ".join(f"({r['kimg']}, {r['sec_per_kimg']:.3f}, {r['augment_p']:.4f})"
                    for r in ticks)
        + f"; less the snapshot (save, eval, best save) of ticks 1-3: "
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
    log_card(f"sg2 loop eval (the CLI's eval_fn, {SG2_LOOP_EVAL_IMAGES} EMA images at batch "
        f"{SG2_LOOP_EVAL_IMAGES // 4}, Inception f32) after each snapshot: "
        + ", ".join(f"{e['s']:.3f}" for e in evals) + " s; FID "
        + ", ".join(f"{f:.4f}" for f in fids) + f"; {len(best_saves)} best snapshots saved ("
        + ", ".join(f"{1e3 * t:.0f}" for t in best_saves) + f" ms); launches {eval_launches}")
    return dict(launches=launches, by_variant=by_variant, ticks=ticks, net_s_per_kimg=net,
                snapshot_mib=size / 2 ** 20, save_ms=1e3 * statistics.median(saves),
                load_ms=1e3 * load_s, eval_s=[e["s"] for e in evals], logs=logs)


class BigGANCardDataset:
    """``BIGGAN_LOOP_IMAGES`` uint8 images in host memory, read through the
    batch loader (``data.loader.normalize_batch``) as an ``HDF5Dataset``
    reads its file's, and class labels and unit instance features drawn
    from a seed on the card, behind the dataset surface the BigGAN trainer
    reads (``rng``, ``which_nn_balance``, ``sample_batch``,
    ``sample_conditioning_instance_balance``, ``len``); indices come from
    ``rng``, a numpy generator the trainer reseeds each epoch and
    checkpoints, as an ``HDF5Dataset``'s."""

    which_nn_balance = "instance_balance"

    def __init__(self, res, n_classes, feat_dim, device, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        n = BIGGAN_LOOP_IMAGES
        self.device = device
        self.images = np.random.default_rng(seed).integers(0, 256, (n, 3, res, res),
                                                           dtype=np.uint8)
        self.labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
        self.feats = F.normalize(torch.randn((n, feat_dim), generator=gen, device=device), dim=1)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return BIGGAN_LOOP_IMAGES

    def _draw(self, n):
        return self.rng.integers(0, BIGGAN_LOOP_IMAGES, n)

    def sample_batch(self, n, weights=None):
        i, j = self._draw(n), self._draw(n)
        images = data_loader.normalize_batch(self.images[i], device=self.device)
        ti, tj = (torch.as_tensor(a, device=self.device) for a in (i, j))
        return Batch(images, self.labels[ti], self.feats[tj], None)

    def sample_conditioning_instance_balance(self, n, weights=None):
        i = torch.as_tensor(self._draw(n), device=self.device)
        return self.labels[i], self.feats[i]


def phase_biggan_loop(device) -> dict:
    """The BigGAN training loop (``Trainer.run``) at full width with class
    conditioning and DiffAugment: B1 and B2 launch 4 and 3 times a step as
    in phase 7; img/s of each epoch from the loop's own clock (the saves
    after it left out); the snapshot's size and save/load time; a bit-for-bit
    reload (the live history and dataset RNG included) and one more step from
    it against the live one; ``make_sampler`` over the folded bf16 EMA G
    with labels and features against direct calls."""
    shutil.rmtree(BIGGAN_LOOP_DIR, ignore_errors=True)
    cfg = BigGANConfig(**BIGGAN_LOOP_MODEL, dtype=torch.bfloat16)
    tcfg = TrainConfig(ema_start=0, class_cond=True, DiffAugment=DIFF_AUGMENT)
    lcfg = biggan_loop.TrainerConfig(
        experiment_name="biggan_loop", weights_root=os.path.join(BIGGAN_LOOP_DIR, "weights"),
        logs_root=os.path.join(BIGGAN_LOOP_DIR, "logs"), num_epochs=BIGGAN_LOOP_EPOCHS,
        test_every=BIGGAN_LOOP_EPOCHS, save_every=1, num_save_copies=1, seed=41,
        batch_size=TRAIN_MB, log_every=1, sv_log_interval=1)
    dataset = BigGANCardDataset(cfg.resolution, cfg.n_classes, cfg.instance_sz, device, seed=42)
    evals = []
    eval_fn = timed_calls(make_train_eval_fn(dict(
        data_root=write_eval_moments(cfg.resolution), resolution=cfg.resolution,
        num_inception_images=BIGGAN_LOOP_EVAL_IMAGES, eval_batch_size=SAMPLER_BATCH),
        device=device), evals)
    t0 = time.perf_counter()
    tr = biggan_loop.Trainer(cfg, tcfg, lcfg, dataset, eval_fn=eval_fn, device=device)
    set_gamma(tr.state.g, tr.state.d, tr.state.g_ema)
    sync()
    n_params = {k: sum(p.numel() for p in getattr(tr.state, k).parameters()) for k in ("g", "d")}
    log(f"biggan loop: Trainer at {cfg.resolution}^2 G_ch {cfg.G_ch} D_ch {cfg.D_ch}, "
        f"class_cond with {cfg.n_classes} classes and {cfg.instance_sz}-d features, "
        f"DiffAugment '{DIFF_AUGMENT}', microbatch {TRAIN_MB}, bf16 compute; G "
        f"{n_params['g'] / 1e6:.2f} M and D {n_params['d'] / 1e6:.2f} M parameters; built in "
        f"{time.perf_counter() - t0:.1f} s")

    per_step, saves = [], []
    real_step, real_save = tr.step_fn, biggan_loop.save_checkpoint

    def step(state, batch, generator):
        c0 = counts()
        out = real_step(state, batch, generator)
        c1 = counts()
        per_step.append({k: c1[k] - c0[k] for k in c0})
        return out

    def save_checkpoint(*args, **kw):
        sync()
        t1 = time.perf_counter()
        path = real_save(*args, **kw)
        saves.append(time.perf_counter() - t1)
        return path

    tr.step_fn = step
    biggan_loop.save_checkpoint = save_checkpoint
    try:
        reset_counts()
        t0 = time.perf_counter()
        tr.run(steps_per_epoch=BIGGAN_LOOP_STEPS)
        sync()
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        biggan_loop.save_checkpoint = real_save
    tr.step_fn = real_step

    n_steps = BIGGAN_LOOP_EPOCHS * BIGGAN_LOOP_STEPS
    if len(per_step) != n_steps or any(
            c != dict(B1=4, B2=3, B3=0, B4=0, B4bwd=0) for c in per_step):
        raise AssertionError(f"biggan loop launches per step {per_step}: expected B1 4 and "
                             "B2 3 (phase 7's), B3 and B4 none")
    # The eval after the last epoch: its metrics in the test log, and the
    # first best copy saved (a snapshot and its copy every epoch, then best0).
    h = tr.history
    if (h["itr"], h["epoch"], h["save_num"], h["save_best_num"]) != (
            n_steps, BIGGAN_LOOP_EPOCHS, 0, 1) or len(saves) != 2 * BIGGAN_LOOP_EPOCHS + 1 \
            or not os.path.isdir(os.path.join(lcfg.weights_root, "biggan_loop_best0")):
        raise AssertionError(f"biggan loop history {h}, {len(saves)} saves, "
                             f"{os.listdir(lcfg.weights_root)}")
    with open(os.path.join(lcfg.logs_root, "biggan_loop", "biggan_loop_test_log.jsonl")) as f:
        tests = [json.loads(line) for line in f]
    eval_b1 = evals[0]["launches"]["B1"] if evals else 0
    if len(evals) != 1 or len(tests) != 1 or tests[0]["itr"] != n_steps \
            or not all(math.isfinite(tests[0][k]) for k in ("FID", "IS_mean", "IS_std")) \
            or tests[0]["FID"] != h["best_FID"] \
            or eval_b1 != math.ceil(BIGGAN_LOOP_EVAL_IMAGES / SAMPLER_BATCH):
        raise AssertionError(f"biggan loop eval: {evals}, test log {tests}")
    with open(os.path.join(lcfg.logs_root, "biggan_loop", "biggan_loop_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if "G_loss" in r]
    spectra = [r for r in recs if any(k.startswith("G_sv/") for k in r)]
    if ([r["itr"] for r in losses] != list(range(1, n_steps + 1)) or len(spectra) != n_steps
            or not all(math.isfinite(v) for r in recs for k, v in r.items() if k != "_stamp")):
        raise AssertionError(f"biggan loop log: {len(losses)} loss and {len(spectra)} spectra "
                             "records, or a value not finite")
    if not all(math.isfinite(r["G_loss"]) and r["D_grad_nonfinite"] == 0 for r in losses):
        raise AssertionError("biggan loop: a loss is not finite or a gradient was scrubbed")
    epochs = [dict(e) for e in tr.epoch_stats]

    # The snapshot into a fresh trainer (other seed), bit for bit.
    wdir = os.path.join(lcfg.weights_root, "biggan_loop")
    size = sum(os.path.getsize(os.path.join(wdir, n)) for n in os.listdir(wdir))
    fresh = biggan_loop.Trainer(cfg, tcfg, dataclasses.replace(lcfg, seed=43), BigGANCardDataset(
        cfg.resolution, cfg.n_classes, cfg.instance_sz, device, seed=42), device=device)
    sync()
    t1 = time.perf_counter()
    fresh.resume()
    sync()
    load_s = time.perf_counter() - t1
    live, back = _state_tensors(tr.state), _state_tensors(fresh.state)
    diff = [k for k, v in live.items()
            if not (torch.equal(v, back[k]) if torch.is_tensor(v) else v == back[k])]
    # The snapshot comes before the eval, which then writes its results into
    # the history (as in the reference): those keys aside, the reload holds
    # the live history, and the live sampler's stream, which the eval
    # leaves alone.
    after_save = {k: v for k, v in fresh.history.items() if k not in EVAL_HISTORY_KEYS}
    if set(live) != set(back) or diff or after_save != {
            k: v for k, v in tr.history.items() if k not in EVAL_HISTORY_KEYS} \
            or fresh.dataset.rng.bit_generator.state != tr.dataset.rng.bit_generator.state:
        raise AssertionError(f"biggan snapshot reload differs in {diff[:5]} or its history or "
                             "dataset RNG state")
    # One more step from each, same batch and generator: phase 12's bars.
    itr = tr.history["itr"]
    batch = tr.make_batch()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, m_live = tr.step_fn(tr.state, batch, tr.step_generator(itr))
        _, m_back = fresh.step_fn(fresh.state, batch, tr.step_generator(itr))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    pairs = {k: (m_live[k].item(), m_back[k].item()) for k in m_live}
    worst_loss = max(abs(a - b) / max(abs(a), 1e-6) for a, b in pairs.values())
    if worst_loss > 1e-4:
        raise AssertionError(f"biggan step after reload: losses differ by {worst_loss:.3e}: "
                             f"{pairs}")
    live, back = _state_tensors(tr.state), _state_tensors(fresh.state)
    worst = dict(state=0.0, weights=0.0)
    for k in [k for k in live if k.startswith(("g.", "d.", "g_ema."))]:
        a, b = live[k].float(), back[k].float()
        err = (a - b).abs().max().item()
        scale = max(a.abs().max().item(), 1e-12)
        kind = "state" if k.endswith((".u0", ".sv0", ".stored_mean", ".stored_var")) else "weights"
        if kind == "state" and err > PARITY_STATE_REL * scale:
            raise AssertionError(f"biggan step after reload: {k} max|Δ| {err:.3e} ({scale:.3e})")
        worst[kind] = max(worst[kind], err / scale)
    del fresh, live, back
    torch.cuda.empty_cache()

    # The folded bf16 EMA G behind the sampler: 200 images with labels and
    # features in batches of 128 (the tail padded) against direct calls.
    g_ema = cast_params(fold_spectral_norm(copy.deepcopy(tr.state.g_ema).eval()), torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(44)
    n = BIGGAN_LOOP_SAMPLES
    z = torch.randn((n, cfg.effective_dim_z), generator=gen, device=device)
    labels, feats = dataset.sample_conditioning_instance_balance(n)
    sampler = make_sampler(g_ema, batch_size=SAMPLER_BATCH, device=device)
    reset_counts()
    got = sampler(z, labels, feats, device_output=True)
    sampler_b1 = counts()["B1"]
    with torch.inference_mode():
        direct = torch.cat([g_ema(z[lo:lo + k], labels[lo:lo + k], feats[lo:lo + k])
                            for lo, k in ((0, SAMPLER_BATCH), (SAMPLER_BATCH, n - SAMPLER_BATCH))])
    sync()
    direct = direct.permute(0, 2, 3, 1)
    batches = math.ceil(n / SAMPLER_BATCH)
    if got.shape != (n, cfg.resolution, cfg.resolution, 3) or sampler_b1 != batches \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"biggan sampler gave {tuple(got.shape)}, B1 launches {sampler_b1}")
    same_batch = torch.equal(got[:SAMPLER_BATCH], direct[:SAMPLER_BATCH])
    dev_ = (got - direct).abs()
    tail_ok = bool((dev_[SAMPLER_BATCH:] <= BF16_TOL["atol"]
                    + BF16_TOL["rtol"] * direct[SAMPLER_BATCH:].abs()).all())
    if not same_batch or not tail_ok:
        raise AssertionError(f"biggan sampler: full batch bit for bit {same_batch}; padded tail "
                             f"max|Δ| {dev_[SAMPLER_BATCH:].max().item():.3e}")
    del g_ema, sampler
    sheets = [n for n in os.listdir(os.path.join(lcfg.logs_root, "biggan_loop"))
              if n.startswith("fixed_samples")]
    log_dir = os.path.join(lcfg.logs_root, "biggan_loop")    # phase 19 prints its series
    rows = plot_logs.read_jsonl(plot_logs.find_train_jsonl(log_dir))
    logs = dict(plot_logs.inception_series(log_dir), **{
        k: plot_logs.series_from_jsonl(rows, k)[1] for k in ("G_loss", "D_loss_real",
                                                             "D_loss_fake")})
    logs["itr"] = plot_logs.series_from_jsonl(rows, "G_loss")[0]
    shutil.rmtree(BIGGAN_LOOP_DIR, ignore_errors=True)

    per_step_imgs = TRAIN_MB * tcfg.num_D_steps * tcfg.num_D_accumulations
    log(f"biggan loop: {n_steps} steps in {wall:.2f} s (saves included); launches per step "
        f"B1 4, B2 3, B3 and B4 0 in each (phase 7's); epochs (s, img/s, the saves after them "
        f"left out): " + ", ".join(f"({e['seconds']:.3f}, {e['img_per_s']:.2f})" for e in epochs)
        + f"; {per_step_imgs} D-real images a step; {len(losses)} loss and {len(spectra)} "
        f"spectra records; progress sheets written: {len(sheets)} (none where PIL is absent)")
    log(f"biggan loop snapshot: {size / 2 ** 20:.1f} MiB; save {1e3 * statistics.median(saves):.0f} "
        f"ms (median of {len(saves)}: " + ", ".join(f"{1e3 * t:.0f}" for t in saves)
        + f"), load {1e3 * load_s:.0f} ms ({size / 2 ** 30 / max(load_s, 1e-9):.2f} GiB/s); "
        f"reload bit for bit in {len(_state_tensors(tr.state))} tensors and counts, the live "
        f"history (less the eval's {len(EVAL_HISTORY_KEYS)} keys) and the live dataset RNG, "
        f"which the eval leaves alone; the next step from it against the live one's (cuDNN deterministic): "
        f"worst relative |Δ| losses {worst_loss:.3e}, state {worst['state']:.3e} (bars 1e-4, "
        f"{PARITY_STATE_REL:g}); weights after Adam {worst['weights']:.3e} of a tensor's "
        f"largest entry (logged)")
    log_card(f"biggan loop eval (make_train_eval_fn, {BIGGAN_LOOP_EVAL_IMAGES} EMA images at batch "
        f"{SAMPLER_BATCH}, Inception f32): {evals[0]['s']:.3f} s, the best copy's save "
        f"{1e3 * saves[-1]:.0f} ms after it; FID {tests[0]['FID']:.4f}, IS "
        f"{tests[0]['IS_mean']:.4f} ± {tests[0]['IS_std']:.4f} in the test log; best0 saved; "
        f"B1 launches {eval_b1} (one a batch)")
    log(f"biggan sampler: make_sampler(folded bf16 EMA G, batch_size {SAMPLER_BATCH}) for "
        f"{n} images with labels and features against direct calls: full batch bit for bit; "
        f"padded tail max|Δ| {dev_[SAMPLER_BATCH:].max().item():.3e} (bar atol "
        f"{BF16_TOL['atol']} + rtol {BF16_TOL['rtol']}); B1 launches {sampler_b1}")
    return dict(launches=launches, per_step=per_step[0], epochs=epochs,
                snapshot_mib=size / 2 ** 20, save_ms=1e3 * statistics.median(saves),
                load_ms=1e3 * load_s, eval_s=evals[0]["s"], logs=logs)


# --- the eval path -------------------------------------------------------------------

def synthetic_inception_state(net) -> dict:
    """``tests/test_inception_graph.py:synthetic_state_dict`` on the names and
    shapes of the port's own state dict: each tensor from
    ``RandomState(crc32(name))``, running variances |x| + 0.5, conv and fc
    weights × 0.05 (the aux head and the counters it also draws touch no
    other tensor)."""
    sd = {}
    for name, t in net.state_dict().items():
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        v = np.asarray(rng.randn(*t.shape), np.float32)
        if name.endswith("running_var"):
            v = np.abs(v) + 0.5
        elif name.endswith("conv.weight") or name == "fc.weight":
            v = v * 0.05
        sd[name] = torch.from_numpy(v)
    return sd


def reference_moments(dim, seed):
    """Synthetic reference moments in float64: mu ~ N(0, 0.1²), sigma =
    A·Aᵀ/dim + 0.1·I with A (dim, dim/4) ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim // 4)
    return rng.randn(dim) * 0.1, a @ a.T / dim + 0.1 * np.eye(dim)


def write_eval_moments(resolution) -> str:
    """The loops' reference moments, as ``eval.pipeline.moments_filename``
    names them, under ``EVAL_DATA_DIR``; returns the directory."""
    os.makedirs(EVAL_DATA_DIR, exist_ok=True)
    mu, sigma = reference_moments(2048, 61)
    np.savez(os.path.join(EVAL_DATA_DIR, moments_filename(resolution)), mu=mu, sigma=sigma)
    return EVAL_DATA_DIR


def moments_f64(pools):
    p = np.asarray(pools, np.float64)
    return p.mean(0), np.cov(p, rowvar=False)


def fid_f64(mu1, s1, mu2, s2) -> float:
    """FID in float64 on the host, the trace tr √(√s1·s2·√s1) from two
    symmetric eigendecompositions (exact at any rank)."""
    w, v = np.linalg.eigh(s1)
    r = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    lam = np.linalg.eigvalsh(r @ s2 @ r)
    d = mu1 - mu2
    return float(d @ d + np.trace(s1) + np.trace(s2) - 2 * np.sqrt(np.clip(lam, 0, None)).sum())


def timed_calls(fn, record: list):
    """``fn`` with the host time of each call (ending in a synchronize) and
    the kernel launches inside it appended to ``record``."""
    def call(*args, **kw):
        sync()
        c0, t0 = counts(), time.perf_counter()
        out = fn(*args, **kw)
        sync()
        c1 = counts()
        record.append(dict(s=time.perf_counter() - t0, launches={k: c1[k] - c0[k] for k in c0}))
        return out
    return call


def _golden_and_card_against_cpu(device) -> dict:
    """Inception on the card against the JAX package's golden outputs, and
    against the CPU (f32) and its own f32 (the bf16 mode) at the synthetic
    and at random weights; then one batch of 128 at 299² timed in NCHW and
    channels-last."""
    net = InceptionV3(device=device)
    sd = synthetic_inception_state(net)
    net.load_state_dict(sd)
    golden = np.load(EVAL_GOLDEN)
    x = np.random.RandomState(1234).uniform(-1.0, 1.0, (2, 75, 75, 3)).astype(np.float32)
    with torch.inference_mode():
        pool, logits = (t.cpu().numpy() for t in net(
            torch.from_numpy(x).permute(0, 3, 1, 2).to(device)))
    worst = {}
    for name, got, (atol, rtol) in (("pool", pool, GOLDEN_POOL), ("logits", logits, GOLDEN_LOGITS)):
        ref = golden[name]
        ratio = (np.abs(got - ref) / (atol + rtol * np.abs(ref))).max()
        worst[name] = (float(np.abs(got - ref).max()), float(ratio))
        if ratio > 1:
            raise AssertionError(f"inception golden {name}: max|Δ| {worst[name][0]:.3e}, "
                                 f"{ratio:.3f} of the bar")
    log_card(f"inception golden (card f32, 2 images 75^2 resized to 299^2, the JAX package's "
        f"tests/golden/inception_golden.npz): pool max|Δ| {worst['pool'][0]:.3e} "
        f"({worst['pool'][1]:.3f} of atol {GOLDEN_POOL[0]:g} + rtol {GOLDEN_POOL[1]:g}), "
        f"logits max|Δ| {worst['logits'][0]:.3e} ({worst['logits'][1]:.3f} of atol "
        f"{GOLDEN_LOGITS[0]:g} + rtol {GOLDEN_LOGITS[1]:g})")

    gen = torch.Generator().manual_seed(62)
    imgs = torch.tanh(torch.randn((INCEPTION_PARITY_IMAGES, 3, INCEPTION_PARITY_RES,
                                   INCEPTION_PARITY_RES), generator=gen))
    random_sd = InceptionV3(device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    parity = {}
    for label, weights in (("synthetic", sd), ("random", random_sd)):
        outs = {}
        for name, dtype, dev in (("cpu", torch.float32, "cpu"), ("f32", torch.float32, device),
                                 ("bf16", torch.bfloat16, device)):
            m = InceptionV3(dtype=dtype, device=dev)
            m.load_state_dict(weights)
            with torch.inference_mode():
                outs[name] = m(imgs.to(dev))[0].cpu()
        ref = outs["cpu"]
        f32_rel = ((outs["f32"] - ref).abs().max() / ref.abs().max()).item()
        scale = outs["f32"].abs().mean().item()
        d16 = (outs["bf16"] - outs["f32"]).abs()
        parity[label] = dict(f32_rel=f32_rel, bf16_max=d16.max().item() / scale,
                             bf16_mean=d16.mean().item() / scale)
        log_card(f"inception card against CPU ({label} weights, {INCEPTION_PARITY_IMAGES} images "
            f"{INCEPTION_PARITY_RES}^2 resized to 299^2): f32 pool max|Δ| {f32_rel:.3e} of its "
            f"largest entry (bar {INCEPTION_F32_REL:g}); bf16 mode against the card's f32: max "
            f"{parity[label]['bf16_max']:.4f}, mean {parity[label]['bf16_mean']:.5f} of the mean "
            f"|pool| {scale:.4e} (bars {INCEPTION_BF16_MAX}, {INCEPTION_BF16_MEAN})")
        if not (f32_rel <= INCEPTION_F32_REL and parity[label]["bf16_max"] <= INCEPTION_BF16_MAX
                and parity[label]["bf16_mean"] <= INCEPTION_BF16_MEAN):
            raise AssertionError(f"inception card against CPU, {label} weights: {parity[label]}")

    x = torch.tanh(torch.randn((SAMPLER_BATCH, 3, 299, 299), generator=gen)).to(device)
    layouts = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = InceptionV3(dtype=dtype, device=device).eval()
        for layout in ("NCHW", "channels_last"):
            if layout == "channels_last":
                m = m.to(memory_format=torch.channels_last)
                xin = x.contiguous(memory_format=torch.channels_last)
            else:
                xin = x
            with torch.inference_mode():
                ms = cuda_ms(lambda: m(xin), reps=5, warmup=2)
            layouts[f"{str(dtype).removeprefix('torch.')} {layout}"] = ms
        del m
    log_card(f"inception alone, batch {SAMPLER_BATCH} at 299^2 (ms, CUDA events, median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in layouts.items()))
    return dict(golden=worst, parity=parity, layouts_ms=layouts)


def _tail_against_f64(device) -> dict:
    """``fid_is_device`` on the card against float64 moments on the host:
    scipy's ``sqrtm`` at full rank (Newton-Schulz on the card), the exact
    eigenvalue trace when rank-deficient (the card's eigenvalue path)."""
    from scipy import linalg as sla

    ref_mu, ref_sigma = reference_moments(2048, 63)
    out = {}
    for n in EVAL_TAIL_POOLS:
        gen = torch.Generator(device=device).manual_seed(64 + n)
        scale = torch.rand((2048,), generator=gen, device=device) * 1.5 + 0.5
        pools = torch.relu(torch.randn((n, 2048), generator=gen, device=device)) * scale
        logits = torch.randn((n, 1000), generator=gen, device=device) * 3
        fid_is_device(pools, logits, ref_mu, ref_sigma)  # warm-up
        sync()
        t0 = time.perf_counter()
        fid, is_mean, is_std = fid_is_device(pools, logits, ref_mu, ref_sigma)
        fid, is_mean, is_std = float(fid), float(is_mean), float(is_std)
        tail_ms = 1e3 * (time.perf_counter() - t0)
        with full_f32_matmul():
            d0 = pools - pools.mean(0)
            sigma = d0.mT @ d0 / (n - 1)
        _, used_eigh = trace_sqrtm_product(sigma, torch.as_tensor(
            ref_sigma, dtype=torch.float32, device=device))
        mu, cov = moments_f64(pools.cpu().numpy())
        if n >= 2048:
            d = mu - ref_mu
            tr = np.trace(sla.sqrtm(cov @ ref_sigma)).real
            ref = float(d @ d + np.trace(cov) + np.trace(ref_sigma) - 2 * tr)
            how = "scipy.linalg.sqrtm"
        else:
            ref, how = fid_f64(mu, cov, ref_mu, ref_sigma), "float64 eigenvalue trace"
        ref_is = inception_score(logits.cpu().numpy())
        rel = abs(fid - ref) / abs(ref)
        rel_is = max(abs(is_mean - ref_is[0]) / ref_is[0], abs(is_std - ref_is[1]) / ref_is[1])
        out[n] = dict(fid=fid, ref=ref, rel=rel, eigh=used_eigh, tail_ms=tail_ms, is_rel=rel_is)
        log_card(f"FID tail, {n} pools against synthetic reference moments: card {fid:.6f} "
            f"({'eigenvalue path' if used_eigh else 'Newton-Schulz'}), host float64 ({how}) "
            f"{ref:.6f}: relative {rel:.3e}; IS relative {rel_is:.3e} (bar {EVAL_REL:g}); "
            f"tail {tail_ms:.2f} ms (moments, square root and IS, host clock)")
        if rel > EVAL_REL or rel_is > EVAL_REL or used_eigh != (n < 2048):
            raise AssertionError(f"FID tail with {n} pools: {out[n]}")
    return out


def _eval_loop(device, profile: bool) -> dict:
    """``evaluate_generator`` over ``make_fused_feature_fn`` of phase 5's
    folded bf16 sampler: 10,000 images at batch 128, Inception in f32 then
    bf16 on one image stream; img/s, the tail, peak memory, B1's launches, the
    FID recomputed on the host in float64, and the FID between the modes.
    ``profile``: device-time breakdowns of one fused batch and of Inception
    alone in each mode."""
    g, _ = build_generator(device)
    sampler = make_sampler(g, batch_size=SAMPLER_BATCH, device=device)
    cfg = g.cfg
    ref_mu, ref_sigma = reference_moments(2048, 65)
    batches = math.ceil(EVAL_IMAGES / SAMPLER_BATCH)
    runs, pools = {}, {}
    for mode in ("f32", "bf16"):
        ev = InceptionEvaluator(deploy_bf16=mode == "bf16", device=device)
        fused = make_fused_feature_fn(sampler, ev)
        gen = torch.Generator(device=device).manual_seed(66)

        def feature_fn(b):
            z = torch.randn((b, cfg.effective_dim_z), generator=gen, device=device)
            feats = torch.randn((b, cfg.instance_sz), generator=gen, device=device)
            return (*fused(z, feats=feats), None)

        feature_fn(SAMPLER_BATCH)  # warm-up, off the stream the pass draws
        gen.manual_seed(66)
        tail, tail_times = [], []
        real_tail = eval_pipeline.fid_is_device

        def recorded_tail(pool, logits, *args, **kw):
            tail.append((pool, logits))
            return real_tail(pool, logits, *args, **kw)

        eval_pipeline.fid_is_device = timed_calls(recorded_tail, tail_times)
        try:
            sync()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = evaluate_generator(None, ev, ref_mu, ref_sigma, num_images=EVAL_IMAGES,
                                     batch=SAMPLER_BATCH, feature_fn=feature_fn)
            sync()
            wall = time.perf_counter() - t0
            launches = counts()
        finally:
            eval_pipeline.fid_is_device = real_tail
        peak = torch.cuda.max_memory_allocated()
        pool, logits = (t.cpu().numpy() for t in tail[0])
        mu, cov = moments_f64(pool)
        host_fid = fid_f64(mu, cov, ref_mu, ref_sigma)
        host_is = inception_score(logits)
        rel = abs(res["FID"] - host_fid) / abs(host_fid)
        rel_is = abs(res["IS_mean"] - host_is[0]) / host_is[0]
        tail_s = tail_times[0]["s"]
        runs[mode] = dict(img_per_s=EVAL_IMAGES / wall, loop_img_per_s=EVAL_IMAGES / (wall - tail_s),
                          wall_s=wall, tail_ms=1e3 * tail_s, peak_gib=peak / 2 ** 30,
                          launches=launches, FID=res["FID"], IS=res["IS_mean"], host_FID=host_fid,
                          fid_rel=rel, is_rel=rel_is)
        pools[mode] = pool
        log_card(f"eval loop, Inception {mode}: evaluate_generator over the fused G (folded bf16, "
            f"{cfg.resolution}^2 ch{cfg.G_ch}) and Inception, {EVAL_IMAGES} images at batch "
            f"{SAMPLER_BATCH}: {wall:.3f} s, {runs[mode]['img_per_s']:.2f} img/s (host clock, "
            f"ending in a synchronize; the feature loop alone {runs[mode]['loop_img_per_s']:.2f}); "
            f"tail {1e3 * tail_s:.2f} ms; peak memory {peak / 2 ** 30:.2f} GiB; launches "
            f"{launches}; FID {res['FID']:.6f}, IS {res['IS_mean']:.6f} ± {res['IS_std']:.3e}; "
            f"host float64 FID {host_fid:.6f} (relative {rel:.3e}), IS relative {rel_is:.3e} "
            f"(bar {EVAL_REL:g})")
        if launches != dict(B1=batches, B2=0, B3=0, B4=0, B4bwd=0):
            raise AssertionError(f"eval loop {mode}: launches {launches}, expected B1 {batches}")
        if rel > EVAL_REL or rel_is > EVAL_REL or pool.shape != (EVAL_IMAGES, 2048) \
                or not np.isfinite(pool).all():
            raise AssertionError(f"eval loop {mode}: {runs[mode]}")
        if profile:
            z = torch.randn((SAMPLER_BATCH, cfg.effective_dim_z), generator=gen, device=device)
            feats = torch.randn((SAMPLER_BATCH, cfg.instance_sz), generator=gen, device=device)
            imgs = sampler(z, feats=feats, device_output=True).permute(0, 3, 1, 2).contiguous()
            with torch.inference_mode():
                phase_profile(f"one eval batch of {SAMPLER_BATCH}, G and Inception {mode}",
                              lambda: fused(z, feats=feats))
                phase_profile(f"Inception {mode} alone on {SAMPLER_BATCH} images of "
                              f"{cfg.resolution}^2", lambda: ev.net(imgs))
        del ev, fused, tail
        torch.cuda.empty_cache()
    between = fid_f64(*moments_f64(pools["f32"]), *moments_f64(pools["bf16"]))
    drift = np.abs(pools["bf16"] - pools["f32"])
    scale = np.abs(pools["f32"]).mean()
    log_card(f"eval loop: FID between the f32 and bf16 Inception on the same {EVAL_IMAGES} images "
        f"(host float64) {between:.6e}; pool drift max {drift.max() / scale:.4f}, mean "
        f"{drift.mean() / scale:.5f} of the mean |pool|")
    del g, sampler
    return dict(runs=runs, fid_between_modes=between)


def phase_eval(device, profile: bool = False) -> dict:
    """Phase 14: Inception against the golden outputs and the CPU, the FID
    tail against float64, and the 10,000-image eval loop."""
    out = _golden_and_card_against_cpu(device)
    torch.cuda.empty_cache()
    out["tail"] = _tail_against_f64(device)
    torch.cuda.empty_cache()
    out.update(_eval_loop(device, profile))
    torch.cuda.empty_cache()
    return out


# --- BigGAN-deep (phase 15) ------------------------------------------------------------

DEEP_SHAPES = (("deep sampler", DEEP_SAMPLER_ATTN, False), ("deep G", DEEP_G_ATTN, True),
               ("deep D", DEEP_D_ATTN, True))


def phase_deep_kernels() -> dict:
    """B1 and B2 at BigGAN-deep's shapes (d 64, dv 256, full length) against
    their plain versions in bf16 and f32, at phase 3's bars; then timed as
    phase 4 times them.  Returns the errors and the timings by shape."""
    fwd_err = bwd_err = 0.0
    for name, shape, _ in DEEP_SHAPES:
        for dtype, atol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
            err = check_fwd(f"{name} {str(dtype)[6:]}", shape, dtype, atol)
            if dtype == torch.bfloat16:
                fwd_err = max(fwd_err, err)
    for name, shape, _ in DEEP_SHAPES[1:]:
        for dtype in (torch.float32, torch.bfloat16):
            err = check_bwd(name, shape, dtype)
            if dtype == torch.bfloat16:
                bwd_err = max(bwd_err, err)
    fwd = {name.split()[1]: time_fwd(name, shape, lse) for name, shape, lse in DEEP_SHAPES}
    bwd = {name.split()[1]: time_bwd(name, shape) for name, shape, _ in DEEP_SHAPES[1:]}
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, fwd=fwd, bwd=bwd)


def attention_layers(net) -> int:
    return sum(isinstance(m, SelfAttention) for m in net.modules())


def expected_step_launches(g, d) -> dict:
    """B1 and B2 launches of one train step (one D step, no accumulation),
    from the attention layers of G (a_g) and D (a_d): the D phase runs G and
    D forward and D backward, the G phase G and D forward and both backward:
    B1 2·(a_g + a_d), B2 2·a_d + a_g (phase 7's 4 and 3 for one each)."""
    a_g, a_d = attention_layers(g), attention_layers(d)
    return dict(B1=2 * (a_g + a_d), B2=2 * a_d + a_g, B3=0, B4=0, B4bwd=0)


def phase_deep_sampler(device, profile: bool = False) -> dict:
    """BigGAN-deep's 256² G from a seed, σ folded, bf16, behind
    ``make_sampler(batch_size=128)``: requests of 128, 200 and 1 with
    labels, B1 launched once a batch and nothing else; img/s at batch 128 and
    peak memory; then phase 6's parity against the CPU in f32."""
    t0 = time.perf_counter()
    cfg = BigGANDeepConfig(**DEEP_MODEL, dtype=torch.bfloat16)
    g = model_classes(cfg)[0](cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(70))
    set_gamma(g)
    unfolded = {k: v.detach().clone() for k, v in g.state_dict().items()}
    fold_spectral_norm(g)
    weights = {k: v.detach().clone() for k, v in g.state_dict().items()}
    cast_params(g, torch.bfloat16)
    sampler = make_sampler(g, batch_size=SAMPLER_BATCH, device=device)
    sync()
    n_params = sum(p.numel() for p in g.parameters())
    log(f"deep sampler: BigGAN-deep {cfg.resolution}^2 ch{cfg.G_ch} depth {cfg.G_depth}, "
        f"{cfg.n_classes} classes, G {n_params / 1e6:.2f} M parameters, built, folded and cast "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(71)
    requests = [(torch.randn((n, cfg.effective_dim_z), generator=gen, device=device),
                 torch.randint(0, cfg.n_classes, (n,), generator=gen, device=device))
                for n in REQUESTS]
    sync()
    reset_counts()
    for z, labels in requests:
        before = counts()
        imgs = sampler(z, labels, device_output=True)
        sync()
        n, batches = z.shape[0], math.ceil(z.shape[0] / SAMPLER_BATCH)
        after = counts()
        launched = {k: after[k] - before[k] for k in after}
        finite = bool(torch.isfinite(imgs).all())
        log(f"deep request {n}: images {tuple(imgs.shape)} in [{imgs.min().item():.4f}, "
            f"{imgs.max().item():.4f}], {batches} batches, launches {launched}")
        if imgs.shape != (n, cfg.resolution, cfg.resolution, 3) or not finite \
                or imgs.abs().max().item() > 1.0 or imgs.float().std().item() == 0.0:
            raise AssertionError(f"deep request {n}: bad images")
        if launched != dict(B1=batches, B2=0, B3=0, B4=0, B4bwd=0):
            raise AssertionError(f"deep request {n}: launches {launched} for {batches} batches")
    launches = counts()["B1"]
    n_batches = sum(math.ceil(z.shape[0] / SAMPLER_BATCH) for z, _ in requests)
    z, labels = requests[0]
    sampler(z, labels, device_output=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        sampler(z, labels, device_output=True)
        sync()
        times.append(time.perf_counter() - t1)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log_card(f"deep sampler batch {SAMPLER_BATCH} bf16: {SAMPLER_BATCH / med:.2f} img/s (median "
             f"of {len(times)} passes, {1e3 * med:.2f} ms/batch; passes ms "
             + ", ".join(f"{1e3 * t:.2f}" for t in times) + f"); peak memory {peak:.2f} GiB; "
             f"B1 launches over the requests {launches} for {n_batches} batches")
    if profile:
        phase_profile(f"one deep sampler batch of {SAMPLER_BATCH}",
                      lambda: sampler(z, labels, device_output=True))
    parity = generator_parity(g, weights, device)
    return dict(g=g, sampler=sampler, unfolded=unfolded, launches=launches,
                launches_per_batch=launches / n_batches, img_per_s=SAMPLER_BATCH / med,
                peak_gib=peak, parity=parity)


def phase_deep_train(device, profile: bool = False) -> dict:
    """BigGAN-deep's G and D from a seed, bf16 compute, ``make_train_step``
    at microbatch 32: one warm-up and 5 timed steps,
    B1 and B2 held to the counts the models give; ms/step, img/s, peak
    memory."""
    cfg, g, d = build_gan(DEEP_MODEL, torch.bfloat16, device, seed=72, deep=True)
    tcfg = TrainConfig(ema_start=0, class_cond=True, instance_cond=False)
    expect = expected_step_launches(g, d)
    mb = DEEP_MB
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    step = make_train_step(tcfg, cfg.effective_dim_z)
    gen = torch.Generator(device=device).manual_seed(73)
    res = cfg.resolution
    batch = dict(x=torch.rand((1, mb, 3, res, res), generator=gen, device=device) * 2 - 1,
                 label=torch.randint(0, cfg.n_classes, (1, mb), generator=gen, device=device),
                 gen_label=torch.randint(0, cfg.n_classes, (2, mb), generator=gen, device=device))
    reset_counts()
    times, metrics_all = [], []
    for i in range(1 + DEEP_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        sync()
        if i > 0:
            times.append(time.perf_counter() - t1)
        metrics_all.append({k: v.item() for k, v in metrics.items()})
    n_steps = 1 + DEEP_STEPS
    got = counts()
    want = {k: v * n_steps for k, v in expect.items()}
    for m in metrics_all:
        log("deep step: " + "  ".join(f"{k} {v:.4f}" for k, v in m.items()))
    if not all(math.isfinite(v) for m in metrics_all for v in m.values()):
        raise AssertionError("a deep step's loss is not finite")
    if got != want:
        raise AssertionError(f"deep train launches {got} over {n_steps} steps, expected {want}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log_card(f"deep train step {cfg.resolution}^2 ch{cfg.G_ch} depth {cfg.G_depth} mb {mb} bf16: "
             f"{1e3 * med:.2f} ms/step (median of {len(times)}; passes ms "
             + ", ".join(f"{1e3 * t:.2f}" for t in times) + f"), {mb / med:.2f} img/s "
             f"(D-real images per step over step time); peak memory {peak:.2f} GiB; launches "
             f"over {n_steps} steps {got} ({expect['B1']} B1 and {expect['B2']} B2 a step)")
    if profile:
        phase_profile(f"one deep train step at microbatch {mb}", lambda: step(state, batch, gen))
    del state, g, d, batch
    torch.cuda.empty_cache()
    return dict(launches=got, per_step=expect, mb=mb, ms_per_step=1e3 * med,
                img_per_s=mb / med, peak_gib=peak)


def phase_deep_loop(device) -> dict:
    """``Trainer.run`` on BigGAN-deep for one epoch of 2 steps from an
    in-memory dataset on the card, a save at its end; each step launches
    what phase 15's train step does; the snapshot reloads bit for bit into
    a fresh trainer."""
    shutil.rmtree(DEEP_LOOP_DIR, ignore_errors=True)
    cfg = BigGANDeepConfig(**DEEP_MODEL, dtype=torch.bfloat16)
    tcfg = TrainConfig(ema_start=0, class_cond=True, instance_cond=False)
    lcfg = biggan_loop.TrainerConfig(
        experiment_name="deep_loop", weights_root=os.path.join(DEEP_LOOP_DIR, "weights"),
        logs_root=os.path.join(DEEP_LOOP_DIR, "logs"), num_epochs=1, test_every=100,
        save_every=1, num_save_copies=0, seed=74, batch_size=DEEP_MB, log_every=1,
        enable_tb=False)
    dataset = BigGANCardDataset(cfg.resolution, cfg.n_classes, cfg.instance_sz, device, seed=75)
    tr = biggan_loop.Trainer(cfg, tcfg, lcfg, dataset, device=device)
    set_gamma(tr.state.g, tr.state.d, tr.state.g_ema)
    expect = expected_step_launches(tr.state.g, tr.state.d)
    per_step = []
    real_step = tr.step_fn

    def step(state, batch, generator):
        c0 = counts()
        out = real_step(state, batch, generator)
        c1 = counts()
        per_step.append({k: c1[k] - c0[k] for k in c0})
        return out

    tr.step_fn = step
    reset_counts()
    t0 = time.perf_counter()
    tr.run(steps_per_epoch=DEEP_LOOP_STEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    tr.step_fn = real_step
    if per_step != [expect] * DEEP_LOOP_STEPS or tr.history["itr"] != DEEP_LOOP_STEPS:
        raise AssertionError(f"deep loop launches per step {per_step}, expected {expect}")
    fresh = biggan_loop.Trainer(cfg, tcfg, dataclasses.replace(lcfg, seed=76), BigGANCardDataset(
        cfg.resolution, cfg.n_classes, cfg.instance_sz, device, seed=75), device=device)
    t1 = time.perf_counter()
    fresh.resume()
    sync()
    load_s = time.perf_counter() - t1
    live, back = _state_tensors(tr.state), _state_tensors(fresh.state)
    diff = [k for k, v in live.items()
            if not (torch.equal(v, back[k]) if torch.is_tensor(v) else v == back[k])]
    if set(live) != set(back) or diff or fresh.history != tr.history \
            or fresh.dataset.rng.bit_generator.state != tr.dataset.rng.bit_generator.state:
        raise AssertionError(f"deep snapshot reload differs in {diff[:5]} or its history or RNG")
    wdir = os.path.join(lcfg.weights_root, "deep_loop")
    size = sum(os.path.getsize(os.path.join(wdir, n)) for n in os.listdir(wdir))
    epoch = tr.epoch_stats[0]
    log_card(f"deep loop: Trainer.run, {DEEP_LOOP_STEPS} steps at microbatch {DEEP_MB} in "
             f"{wall:.2f} s with the save; epoch {epoch['seconds']:.3f} s, "
             f"{epoch['img_per_s']:.2f} img/s; launches per step {per_step[0]}; snapshot "
             f"{size / 2 ** 20:.1f} MiB, reloaded bit for bit in {len(live)} tensors and counts "
             f"({1e3 * load_s:.0f} ms), with the history and the dataset RNG")
    del tr, fresh, live, back
    shutil.rmtree(DEEP_LOOP_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, per_step=per_step[0], snapshot_mib=size / 2 ** 20)


# --- the inference entry points (phase 16) -----------------------------------------------

def _flat_argv(path, cfg, device) -> list:
    """A CLI's arguments: the config written to ``path`` and ``--device``."""
    with open(path, "w") as f:
        json.dump(cfg, f)
    return ["--json_config", path, "--device", str(device)]


def _grid(images_u8, rows, cols):
    n, h, w, c = images_u8.shape
    r = images_u8.reshape(rows, cols, h, w, c)
    return np.concatenate([np.concatenate(list(x), axis=1) for x in r], axis=0)


def phase_inference(device, deep) -> dict:
    """The inference entry points on the card: ``cli/generate_images.py``
    from a native checkpoint of phase 5's IC-GAN G, ``load_generator`` from
    an upstream ``.pth`` bundle of phase 15's BigGAN-deep G, ``cli/demo.py``
    with a ResNet-50 from a seed, and ``make_conditioned_sampler`` over an
    in-memory dataset in both balance modes.  Each is held against direct
    calls of the same weights, B1 counted in each."""
    from PIL import Image

    from ic_gan_tpu_torch.cli import demo as demo_cli
    from ic_gan_tpu_torch.cli import generate_images as generate_cli
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli.config import split_config
    from ic_gan_tpu_torch.io.checkpoint import save_checkpoint
    from ic_gan_tpu_torch.models.resnet import ResNet50, load_torch_resnet50

    shutil.rmtree(INFERENCE_DIR, ignore_errors=True)
    os.makedirs(INFERENCE_DIR)
    out = {}
    # 1. A native checkpoint of the IC-GAN G and D, named as Trainer names a
    # best copy, and a stored-instances file.
    cfg, tcfg = split_config(INFERENCE_FLAT)[:2]
    gen = torch.Generator(device=device).manual_seed(80)
    g, d = Generator(cfg, device=device, generator=gen), Discriminator(cfg, device=device,
                                                                        generator=gen)
    set_gamma(g, d)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    weights_root = os.path.join(INFERENCE_DIR, "weights")
    sync()
    t0 = time.perf_counter()
    save_checkpoint(weights_root, "icgan", state, config={"best_FID": 12.5, "best_IS": 3.0},
                    suffix="best0")
    save_s = time.perf_counter() - t0
    ema = {k: v.detach().clone() for k, v in state.g_ema.state_dict().items()}
    del state, g, d
    torch.cuda.empty_cache()
    rng = np.random.RandomState(81)
    feats = rng.randn(STORED_INSTANCES, cfg.instance_sz).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = rng.randint(0, 1000, STORED_INSTANCES)
    stored = os.path.join(INFERENCE_DIR, "stored_instances.npy")
    np.save(stored, dict(instance_features=feats, labels=labels), allow_pickle=True)
    flat = dict(INFERENCE_FLAT, weights_root=weights_root, experiment_name="icgan",
                deploy_bf16=True)

    # 2. generate_images: 5 conditionings × 5 images, one padded batch of 32.
    grid_path = os.path.join(INFERENCE_DIR, "grid.png")
    argv = _flat_argv(os.path.join(INFERENCE_DIR, "generate.json"),
                      dict(flat, stored_features=stored, num_conditionings_gen=5, num_imgs_gen=5,
                           out_path=grid_path), device)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    generate_cli.main(argv)
    sync()
    gen_s = time.perf_counter() - t0
    gen_launches = counts()
    grid = np.asarray(Image.open(grid_path).convert("RGB"))
    g16 = skip_init(Generator, cfg.replace(dtype=torch.bfloat16), device=device)
    g16.load_state_dict(ema)
    cast_params(fold_spectral_norm(g16), torch.bfloat16)
    direct = make_sampler(g16, batch_size=INFERENCE_BATCH, device=device)
    z, _, f, idxs = inf.get_conditionings(5, 5, feats, labels, cfg.effective_dim_z, seed=0)
    want = _grid(generate_cli.to_uint8(direct(z, None, f)), 5, 5)
    delta = np.abs(grid.astype(np.int16) - want.astype(np.int16))
    # bf16's bars (atol 2e-2 + rtol 2e-2 of images in [-1, 1]) in uint8 levels.
    if grid.shape != (5 * cfg.resolution, 5 * cfg.resolution, 3) or delta.max() > 6 \
            or gen_launches != dict(B1=1, B2=0, B3=0, B4=0, B4bwd=0):
        raise AssertionError(f"generate_images: grid {grid.shape}, max|Δ| {delta.max()} levels "
                             f"against direct calls, launches {gen_launches}")
    log_card(f"generate_images (native checkpoint best0 of the {cfg.resolution}^2 ch{cfg.G_ch} "
             f"IC-GAN G, deploy_bf16, 5 x 5 from {STORED_INSTANCES} stored instances, --device "
             f"{device}): {gen_s:.2f} s end to end with the load (the checkpoint's save took "
             f"{save_s:.2f} s); grid {grid.shape}; against make_sampler on the same z and "
             f"features: {'bit for bit' if delta.max() == 0 else f'max|Δ| {delta.max()} levels'}"
             f"; launches {gen_launches}")
    out.update(generate_launches=gen_launches["B1"], generate_s=gen_s)
    del g16, direct
    torch.cuda.empty_cache()

    # 3. An upstream .pth bundle of phase 15's BigGAN-deep G (upstream names:
    # no standing counters), through load_generator and load_model_inference.
    pth_dir = os.path.join(INFERENCE_DIR, "deep_pth")
    os.makedirs(pth_dir)
    torch.save({k: v.cpu() for k, v in deep["unfolded"].items()
                if not k.endswith("accum_counter")}, os.path.join(pth_dir, "G_ema.pth"))
    deep_flat = dict(model="BigGANdeep", **DEEP_MODEL)
    torch.save({"config": deep_flat, "best_FID": 7.0}, os.path.join(pth_dir, "state_dict.pth"))
    loaded, lcfg = inf.load_generator(dict(deep_flat, pth_dir=pth_dir), device=device)
    same = all(torch.equal(v, deep["unfolded"][k]) for k, v in loaded.state_dict().items())
    del loaded
    sampler, _ = inf.load_model_inference(dict(deep_flat, pth_dir=pth_dir, deploy_bf16=True,
                                               batch_size=SAMPLER_BATCH), device=device)
    gen = torch.Generator(device=device).manual_seed(84)
    z = torch.randn((SAMPLER_BATCH, lcfg.effective_dim_z), generator=gen, device=device)
    lab = torch.randint(0, lcfg.n_classes, (SAMPLER_BATCH,), generator=gen, device=device)
    reset_counts()
    got = sampler(z, lab, device_output=True)
    pth_launches = counts()
    ref = deep["sampler"](z, lab, device_output=True)
    sync()
    bitwise = torch.equal(got, ref)
    if not same or not isinstance(lcfg, BigGANDeepConfig) or not bitwise \
            or pth_launches != dict(B1=1, B2=0, B3=0, B4=0, B4bwd=0):
        raise AssertionError(f"deep .pth: weights equal {same}, images equal {bitwise}, "
                             f"launches {pth_launches}")
    log(f"deep .pth bundle: load_generator gave the bundle's weights exactly; "
        f"load_model_inference (deploy_bf16, batch {SAMPLER_BATCH}) against phase 15's sampler "
        f"on the same z and labels: bit for bit; launches {pth_launches}")
    out["pth_launches"] = pth_launches["B1"]
    del sampler, got, ref
    torch.cuda.empty_cache()

    # 4. The demo: a ResNet-50 from a seed saved with torchvision's names,
    # one cell of the grid as the user's image, 16 samples ranked.
    net = ResNet50(device=device, generator=torch.Generator(device=device).manual_seed(82))
    rn50 = os.path.join(INFERENCE_DIR, "rn50.pth")
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, rn50)
    image = os.path.join(INFERENCE_DIR, "input.png")
    Image.fromarray(grid[:cfg.resolution, :cfg.resolution]).save(image)
    demo_flat = dict(flat, input_image=image, feature_extractor_weights=rn50,
                     num_samples=DEMO_SAMPLES, out_path=os.path.join(INFERENCE_DIR, "demo.png"))
    argv = _flat_argv(os.path.join(INFERENCE_DIR, "demo.json"), demo_flat, device)
    reset_counts()
    t0 = time.perf_counter()
    _, order = demo_cli.main(argv)
    sync()
    demo_s = time.perf_counter() - t0
    demo_launches = counts()
    loaded = load_torch_resnet50(torch.load(rn50, weights_only=True), device=device)
    target = demo_cli.extract_features(image, loaded)
    sampler, mcfg = inf.load_model_inference(demo_flat, device=device)
    z = torch.randn((DEMO_SAMPLES, mcfg.effective_dim_z),
                    generator=torch.Generator().manual_seed(0))
    imgs = sampler(z, None, np.repeat(target[None], DEMO_SAMPLES, axis=0))
    sims = (demo_cli.features(loaded, (torch.from_numpy(imgs).permute(0, 3, 1, 2) + 1) / 2)
            @ torch.as_tensor(target, device=device)).cpu().numpy()
    ranked = sims[order]
    grid_demo = np.asarray(Image.open(demo_flat["out_path"]))
    nrow = math.ceil(math.sqrt(DEMO_SAMPLES))
    if not (np.diff(ranked) <= 1e-5).all() or sorted(order) != list(range(DEMO_SAMPLES)) \
            or grid_demo.shape != (math.ceil(DEMO_SAMPLES / nrow) * cfg.resolution,
                                   nrow * cfg.resolution, 3) \
            or demo_launches["B1"] != 1:
        raise AssertionError(f"demo: similarities in its order {ranked}, grid {grid_demo.shape}, "
                             f"launches {demo_launches}")
    x = torch.rand((DEMO_SAMPLES, 3, 224, 224), generator=torch.Generator(device=device)
                   .manual_seed(85), device=device)
    with torch.inference_mode():
        rn_ms = cuda_ms(lambda: loaded(x))
    log_card(f"demo (ResNet-50 from a seed as feature_extractor_weights, a {cfg.resolution}^2 "
             f"cell of the grid as the input, {DEMO_SAMPLES} samples): {demo_s:.2f} s end to end; "
             f"its order sorts the cosine similarities taken with the loaded network "
             f"(descending, {ranked[0]:.6f} … {ranked[-1]:.6f}); B1 launches {demo_launches['B1']}"
             f"; ResNet-50 f32 at batch {DEMO_SAMPLES}, 224^2: {rn_ms:.3f} ms")
    out.update(demo_launches=demo_launches["B1"], resnet50_ms=rn_ms)

    # 5. make_conditioned_sampler over an in-memory dataset, both balance
    # modes: 200 images in batches of 128, against the sampler on its draws.
    cond_flat = dict(flat, batch_size=SAMPLER_BATCH, seed=3)
    sampler, mcfg = inf.load_model_inference(cond_flat, device=device)
    cond_launches = 0
    for balance in ("instance_balance", "nnclass_balance"):
        runs = []
        for _ in range(2):
            ds = CardDataset(cfg.resolution, cfg.instance_sz, device, seed=86)
            ds.which_nn_balance = balance
            runs.append(inf.make_conditioned_sampler(cond_flat, sampler, mcfg, ds))
        reset_counts()
        imgs, lab = runs[0](200)
        cond_launches += counts()["B1"]
        zq, lq, fq, _ = runs[1].draw(200)
        again = sampler(zq, lq, fq, device_output=True)
        sync()
        if imgs.shape != (200, cfg.resolution, cfg.resolution, 3) or lab is not None \
                or not torch.equal(imgs, again) or not bool(torch.isfinite(imgs).all()):
            raise AssertionError(f"conditioned sampler ({balance}): {tuple(imgs.shape)}")
    if cond_launches != 2 * math.ceil(200 / SAMPLER_BATCH):
        raise AssertionError(f"conditioned sampler: {cond_launches} B1 launches")
    log(f"make_conditioned_sampler (CardDataset, instance and nnclass balance, 200 images at "
        f"batch {SAMPLER_BATCH}): images equal the sampler's on the same draws; B1 launches "
        f"{cond_launches}")
    out["conditioned_launches"] = cond_launches
    del sampler
    shutil.rmtree(INFERENCE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = (out["generate_launches"] + out["pth_launches"] + out["demo_launches"]
                       + cond_launches)
    return out


# --- data preparation and the eval CLIs (phase 17) -----------------------------------------

@contextlib.contextmanager
def memory_dataset(make):
    """``get_dataset_hdf5`` replaced by ``make()`` for the block: the card's
    machine has no ``h5py``, so the CLIs read an in-memory dataset."""
    from ic_gan_tpu_torch.data import datasets as datasets_mod

    real = datasets_mod.get_dataset_hdf5
    datasets_mod.get_dataset_hdf5 = lambda **kw: make()
    try:
        yield
    finally:
        datasets_mod.get_dataset_hdf5 = real


class MemoryDataset:
    """uint8 NCHW images and their unit instance features in host memory,
    behind the methods the eval reads on an ``HDF5Dataset``: real images
    through ``_get_images`` (the eval maps them through the batch loader
    with ``_norm``'s formula), instance-balanced conditioning drawn from a
    numpy stream ``rng``."""

    which_nn_balance = "instance_balance"
    root = "chip_smoke_memory_dataset"

    def __init__(self, imgs, feats, seed):
        self.imgs, self.feats = imgs, feats
        self.possible_sampling_idxs = np.arange(len(imgs))
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.imgs)

    def _get_images(self, idxs):
        return self.imgs[np.asarray(idxs)]

    def get_label(self, idxs):
        return np.zeros(len(np.atleast_1d(idxs)), np.int64)

    def sample_conditioning_instance_balance(self, n):
        return None, self.feats[self.rng.integers(0, len(self.feats), n)]


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30 if DEV == "cuda" else 0.0


def reset_peak():
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _near_tie(d_sorted, i, tol):
    """Whether entry ``i`` of an ascending row lies within ``tol`` of a
    neighbour."""
    return (i > 0 and d_sorted[i] - d_sorted[i - 1] <= tol) or (
        i + 1 < len(d_sorted) and d_sorted[i + 1] - d_sorted[i] <= tol)


def _prepare_features(device) -> dict:
    """Step 1: ``PREP_IMAGES`` uint8 images through the ``extract_features``
    core with the flip bank, on a ResNet-50 from a seed read back from a
    torchvision-format ``.pth``."""
    from ic_gan_tpu_torch.cli.prepare_data import iter_features, load_feature_extractor
    from ic_gan_tpu_torch.models.resnet import ResNet50, preprocess

    gen = torch.Generator(device=device).manual_seed(90)
    imgs = torch.randint(0, 256, (PREP_IMAGES, 3, PREP_RES, PREP_RES), generator=gen,
                         device=device, dtype=torch.uint8).cpu().numpy()
    pth = os.path.join(PREP_DIR, "rn50.pth")
    torch.save(ResNet50(device="cpu", generator=torch.Generator().manual_seed(91)).state_dict(),
               pth)
    net = load_feature_extractor(pth, device=device)
    rows = list(iter_features(imgs[:PREP_BATCH], net, PREP_BATCH))   # warm-up
    reset_peak()
    sync()
    t0 = time.perf_counter()
    rows = list(iter_features(imgs, net, PREP_BATCH))
    sync()
    secs = time.perf_counter() - t0
    feats = np.concatenate([r[2] for r in rows])
    flipped = np.concatenate([r[3] for r in rows])
    x = torch.as_tensor(imgs[:PREP_BATCH], device=device).float() / 255.0
    with torch.inference_mode():
        direct = net(preprocess(x))[0].cpu().numpy()
        direct_flip = net(preprocess(x.flip(3)))[0].cpu().numpy()
    bitwise = (np.array_equal(direct, feats[:PREP_BATCH])
               and np.array_equal(direct_flip, flipped[:PREP_BATCH]))
    if feats.shape != (PREP_IMAGES, 2048) or not np.isfinite(feats).all() or not bitwise:
        raise AssertionError(f"features {feats.shape}, first batch bit for bit: {bitwise}")
    log_card(f"prepare_data features (ResNet-50 from a seed via a torchvision .pth, "
             f"{PREP_IMAGES} uint8 images at {PREP_RES}^2 -> 224^2 bicubic, batch {PREP_BATCH}, "
             f"flip bank): {secs:.2f} s, {2 * PREP_IMAGES / secs:.1f} img/s counting the flips "
             f"({PREP_IMAGES / secs:.1f} source img/s), peak {peak_gib():.2f} GiB; the first "
             f"batch equals direct ResNet50(preprocess(x)) calls bit for bit")
    return dict(imgs=imgs, feats=feats, features_s=secs,
                features_img_per_s=2 * PREP_IMAGES / secs, features_peak_gib=peak_gib())


def _bank(device) -> np.ndarray:
    """``BANK_ROWS`` × 2048 rows from a mixture of ``BANK_CLUSTERS``
    Gaussians drawn from a seed on the card, unit-normalized."""
    gen = torch.Generator(device=device).manual_seed(92)
    n, dim = BANK_ROWS, 2048
    centres = torch.randn((BANK_CLUSTERS, dim), generator=gen, device=device)
    which = torch.randint(0, BANK_CLUSTERS, (n,), generator=gen, device=device)
    x = centres[which] + 0.5 * torch.randn((n, dim), generator=gen, device=device)
    return F.normalize(x, dim=1).cpu().numpy()


def _knn_and_kmeans(device) -> dict:
    """Steps 2 and 3: the exact k-NN table (``nns_of``, ``build_nns``' core)
    and the k-means selection (``kmeans`` + ``closest_real_to_centroids``,
    ``build_kmeans``' core) over an ImageNet-LT-sized bank, each checked
    against float64 on the host."""
    from ic_gan_tpu_torch.cli.prepare_data import nns_of
    from ic_gan_tpu_torch.data.feature_bank import closest_real_to_centroids, kmeans

    bank = _bank(device)
    n, dim = bank.shape
    reset_peak()
    sync()
    t0 = time.perf_counter()
    idx, radii = nns_of(bank, k_nn=BANK_K - 1, device=device)
    knn_s = time.perf_counter() - t0
    knn_peak = peak_gib()
    flops = 2.0 * n * n * dim
    rng = np.random.RandomState(93)
    b64 = bank.astype(np.float64)
    b2 = (b64 * b64).sum(1)
    rows = rng.choice(n, KNN_CHECK_ROWS, replace=False)
    d64 = b2[rows, None] + b2[None] - 2.0 * (b64[rows] @ b64.T)
    worst_d = worst_r = 0.0
    mismatched = 0
    for j, q in enumerate(rows):
        order = np.sort(d64[j])[:BANK_K + 1]       # one more, for a tie at the k-th
        worst_d = max(worst_d, float(np.abs(d64[j, idx[q]] - order[:BANK_K]).max()))
        worst_r = max(worst_r, abs(float(radii[q]) ** 2 - float(order[BANK_K - 1])))
        want = np.argsort(d64[j], kind="stable")[:BANK_K]
        mismatched += sum(idx[q, i] != want[i] and not _near_tie(order, i, KNN_TOL)
                          for i in range(BANK_K))
    if idx.shape != (n, BANK_K) or (idx[:, 0] != np.arange(n)).any() or worst_d > KNN_TOL \
            or worst_r > KNN_TOL or mismatched:
        raise AssertionError(f"knn: worst |d - d64| {worst_d:.3g}, radii² {worst_r:.3g}, "
                             f"{mismatched} indices off away from near-ties")
    log_card(f"prepare_data k-NN (nns_of: {n} x {dim} f32 bank, a mixture of {BANK_CLUSTERS} "
             f"Gaussians, unit rows, k {BANK_K}): {knn_s:.2f} s, {flops / knn_s / 1e12:.1f} "
             f"TFLOP/s of 2*N^2*D, peak {knn_peak:.2f} GiB; {KNN_CHECK_ROWS} rows against "
             f"float64: distances within {worst_d:.2e}, radii^2 within {worst_r:.2e}, indices "
             f"equal away from near-ties ({KNN_TOL})")

    reset_peak()
    sync()
    t0 = time.perf_counter()
    centroids, assign = kmeans(bank, num_clusters=KMEANS_K, num_iters=KMEANS_ITERS, seed=0,
                               device=device)
    centres = closest_real_to_centroids(bank, centroids, device=device)
    km_s = time.perf_counter() - t0
    km_peak = peak_gib()
    c64 = centroids.astype(np.float64)
    c2 = (c64 * c64).sum(1)
    rows = rng.choice(n, KMEANS_CHECK_ROWS, replace=False)
    dc = b2[rows, None] + c2[None] - 2.0 * (b64[rows] @ c64.T)
    top2 = np.sort(dc, axis=1)[:, :2]
    off = (assign[rows] != dc.argmin(1)) & (top2[:, 1] - top2[:, 0] > KNN_TOL)
    sums = torch.zeros((KMEANS_K, dim), dtype=torch.float64).index_add_(
        0, torch.as_tensor(assign), torch.from_numpy(b64)).numpy()
    counts = np.bincount(assign, minlength=KMEANS_K)
    filled = counts > 0
    mean_err = float(np.abs(sums[filled] / counts[filled, None] - c64[filled]).max())
    picks = rng.choice(KMEANS_K, KMEANS_CHECK_CENTROIDS, replace=False)
    dr = c2[picks, None] + b2[None] - 2.0 * (c64[picks] @ b64.T)
    srt = np.sort(dr, axis=1)[:, :2]
    wrong_pick = (centres[picks] != dr.argmin(1)) & (srt[:, 1] - srt[:, 0] > KNN_TOL)
    if off.any() or mean_err > 1e-5 or wrong_pick.any():
        raise AssertionError(f"kmeans: {int(off.sum())} rows not at their nearest centroid, "
                             f"centroid vs mean {mean_err:.3g}, {int(wrong_pick.sum())} picks")
    log_card(f"prepare_data k-means (K {KMEANS_K}, {KMEANS_ITERS} Lloyd iterations, then "
             f"closest_real_to_centroids): {km_s:.2f} s, peak {km_peak:.2f} GiB; "
             f"{KMEANS_CHECK_ROWS} rows at their float64-nearest final centroid (away from "
             f"near-ties), centroids the means of their rows within {mean_err:.2e}, "
             f"{KMEANS_CHECK_CENTROIDS} picks the float64-nearest rows; {int(filled.sum())} "
             f"clusters filled")
    return dict(knn_s=knn_s, knn_tflops=flops / knn_s / 1e12, knn_peak_gib=knn_peak,
                kmeans_s=km_s, kmeans_peak_gib=km_peak)


def _moments(device, imgs) -> dict:
    """Step 4: ``compute_dataset_moments`` over the first ``MOMENTS_IMAGES``
    step-1 images in memory (Inception f32, random weights from a seed),
    ``save_moments`` and a reload."""
    from ic_gan_tpu_torch.eval.pipeline import compute_dataset_moments, save_moments

    ev = InceptionEvaluator(device=device)
    ds = MemoryDataset(imgs[:MOMENTS_IMAGES], None, 0)
    sync()
    t0 = time.perf_counter()
    mu, sigma, _ = compute_dataset_moments(ds, ev, batch=PREP_BATCH)[""]
    secs = time.perf_counter() - t0
    name = moments_filename(PREP_RES)
    save_moments(PREP_DIR, name, mu, sigma)
    back = np.load(os.path.join(PREP_DIR, name))
    if mu.shape != (2048,) or sigma.shape != (2048, 2048) or not np.isfinite(sigma).all() \
            or not (np.array_equal(back["mu"], mu) and np.array_equal(back["sigma"], sigma)):
        raise AssertionError("moments")
    log_card(f"prepare_data moments (compute_dataset_moments, {len(ds)} images at "
             f"{PREP_RES}^2, Inception f32 at batch {PREP_BATCH}, in memory): {secs:.2f} s, "
             f"{len(ds) / secs:.1f} img/s; saved and reloaded as {name}")
    return dict(moments_s=secs, moments_img_per_s=len(ds) / secs)


def _rel_delta(got, want) -> float:
    return max(abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-12)
               for k, v in want.items() if not isinstance(v, str))


def _test_cli(device, imgs, feats) -> dict:
    """Step 5: ``cli/test.py``'s ``main`` on a native checkpoint of phase 5's
    IC-GAN G, ``deploy_bf16``, with PRDC, standing statistics and a sample
    npz, against a direct ``evaluate_generator`` call on the same draws."""
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli import test as test_cli
    from ic_gan_tpu_torch.cli.config import split_config
    from ic_gan_tpu_torch.eval.pipeline import cached_real_features
    from ic_gan_tpu_torch.io.checkpoint import save_checkpoint

    cfg, tcfg = split_config(INFERENCE_FLAT)[:2]
    gen = torch.Generator(device=device).manual_seed(80)
    g, d = Generator(cfg, device=device, generator=gen), Discriminator(cfg, device=device,
                                                                        generator=gen)
    set_gamma(g, d)
    state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
    save_checkpoint(os.path.join(PREP_DIR, "weights"), "icgan", state,
                    config={"best_FID": 12.5, "best_IS": 3.0}, suffix="best0")
    del state, g, d
    torch.cuda.empty_cache()
    flat = dict(INFERENCE_FLAT, weights_root=os.path.join(PREP_DIR, "weights"),
                experiment_name="icgan", deploy_bf16=True, data_root=PREP_DIR, seed=5,
                batch_size=TEST_CLI_BATCH, eval_batch_size=TEST_CLI_BATCH,
                num_inception_images=TEST_CLI_IMAGES, eval_prdc=True,
                prdc_ref_images=TEST_CLI_IMAGES, accumulate_stats=True, sample_npz=True,
                sample_num_npz=TEST_CLI_NPZ, npz_path=os.path.join(PREP_DIR, "samples.npz"),
                metrics_out=os.path.join(PREP_DIR, "metrics.npy"))
    argv = _flat_argv(os.path.join(PREP_DIR, "test.json"), flat, device)

    def dataset():
        return MemoryDataset(imgs, feats, 6)

    with memory_dataset(dataset):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        got = test_cli.main(argv)
        sync()
        secs = time.perf_counter() - t0
        launches = counts()
    # The same calls by hand, in the CLI's order.
    sampler, mcfg = inf.load_model_inference(flat, device=device)
    ds = dataset()
    sampler = sampler.with_standing_stats(lambda n: ds.sample_conditioning_instance_balance(n))
    sample = inf.make_conditioned_sampler(flat, sampler, mcfg, ds)
    ev = InceptionEvaluator(device=device)
    ref = np.load(os.path.join(PREP_DIR, moments_filename(PREP_RES)))
    prdc = cached_real_features(ds, ev, os.path.join(PREP_DIR, "feature_cache"),
                                TEST_CLI_IMAGES, batch=TEST_CLI_BATCH)
    want = evaluate_generator(test_cli.nchw(sample), ev, ref["mu"], ref["sigma"],
                              num_images=TEST_CLI_IMAGES, batch=TEST_CLI_BATCH,
                              prdc_ref_features=prdc, prdc_nearest_k=5,
                              feature_fn=inf.make_conditioned_feature_fn(sample, ev))
    delta = _rel_delta(got, want)
    npz = np.load(flat["npz_path"])["x"]
    saved = np.load(flat["metrics_out"], allow_pickle=True).item()
    batches = math.ceil(TEST_CLI_IMAGES / TEST_CLI_BATCH)
    expect = 16 + batches + math.ceil(TEST_CLI_NPZ / TEST_CLI_BATCH)  # standing, eval, npz
    if delta > CLI_REL or launches != dict(B1=expect, B2=0, B3=0, B4=0, B4bwd=0) \
            or npz.shape != (TEST_CLI_NPZ, 3, cfg.resolution, cfg.resolution) \
            or npz.dtype != np.uint8 or set(saved) != set(want) \
            or not all(np.isfinite(v) for v in want.values()):
        raise AssertionError(f"test CLI: max rel |Δ| {delta:.3g} against direct calls, "
                             f"launches {launches} (expected B1 {expect}), npz {npz.shape}")
    log_card(f"cli/test.py (native checkpoint of the {cfg.resolution}^2 ch{cfg.G_ch} IC-GAN G, "
             f"deploy_bf16, accumulate_stats, {TEST_CLI_IMAGES} images at batch "
             f"{TEST_CLI_BATCH}, eval_prdc over {TEST_CLI_IMAGES} real images, sample_npz "
             f"{TEST_CLI_NPZ}; dataset in memory: no h5py on this machine): {secs:.2f} s end to "
             f"end with the load; FID {got['FID']:.4f} IS {got['IS_mean']:.4f} precision "
             f"{got['precision']:.4f} recall {got['recall']:.4f}; max rel |Δ| against a direct "
             f"evaluate_generator on the same draws {delta:.2e}; B1 launches {launches['B1']} "
             f"(16 standing + {batches} eval + {expect - 16 - batches} npz batches)")
    return dict(test_s=secs, test_launches=launches["B1"], test_delta=delta)


def _sg2_snapshot(device, directory=None) -> str:
    """Phase 12's StyleGAN2 model (256², ``h_dim`` 2048) from a seed, layer
    noise on, as a torch network snapshot (a dict of modules carrying their
    ``init_kwargs``, which ``load_network_pkl`` reads)."""
    import pickle

    cfg = sg2.StyleGAN2Config(**SG2_MODEL)
    g = sg2.Generator(cfg, device=device, generator=torch.Generator(device=device).manual_seed(94))
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    g = g.cpu()
    g.init_kwargs = dict(
        img_resolution=cfg.img_resolution, z_dim=cfg.z_dim, c_dim=cfg.c_dim, h_dim=cfg.h_dim,
        w_dim=cfg.w_dim, mapping_kwargs=dict(num_layers=cfg.num_mapping_layers),
        synthesis_kwargs=dict(channel_base=cfg.channel_base, channel_max=cfg.channel_max,
                              num_fp16_res=cfg.num_fp16_res, conv_clamp=cfg.conv_clamp,
                              architecture=cfg.architecture_g))
    path = os.path.join(directory or PREP_DIR, "sg2-snapshot.pkl")
    with open(path, "wb") as f:
        pickle.dump({"G_ema": g}, f)
    return path


def _calc_metrics_cli(device, imgs, feats) -> dict:
    """Step 6: ``cli/calc_metrics.py``'s ``main`` on the StyleGAN2 snapshot,
    five registry metrics, LPIPS from a VGG16 file through
    ``$ICGAN_VGG16_WEIGHTS``, each metric against a direct ``calc_metric``
    call on the same draws; LPIPS on the card against the CPU."""
    from ic_gan_tpu_torch.cli import calc_metrics as calc_cli
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli.test import nchw
    from ic_gan_tpu_torch.eval.metrics import calc_metric, make_lpips_feature_fn
    from ic_gan_tpu_torch.eval.pipeline import cached_real_features
    from ic_gan_tpu_torch.models.vgg import VGG16, LPIPSEvaluator

    pkl = _sg2_snapshot(device)
    vgg_path = os.path.join(PREP_DIR, "vgg16.pth")
    torch.save(VGG16(device="cpu", generator=torch.Generator().manual_seed(95)).state_dict(),
               vgg_path)
    flat = dict(backbone="stylegan2", network_pkl=pkl, resolution=PREP_RES, data_root=PREP_DIR,
                seed=7, batch_size=CALC_BATCH, eval_batch_size=CALC_BATCH,
                num_inception_images=CALC_IMAGES, ppl_num_samples=PPL_SAMPLES,
                metrics=",".join(CALC_METRICS), run_dir=os.path.join(PREP_DIR, "metrics"))
    argv = _flat_argv(os.path.join(PREP_DIR, "calc.json"), flat, device)

    def dataset():
        return MemoryDataset(imgs, feats, 8)

    env = os.environ.get("ICGAN_VGG16_WEIGHTS")
    os.environ["ICGAN_VGG16_WEIGHTS"] = vgg_path
    try:
        with memory_dataset(dataset):
            reset_counts()
            sync()
            t0 = time.perf_counter()
            got = calc_cli.main(argv)
            sync()
            secs = time.perf_counter() - t0
            launches = counts()
    finally:
        if env is None:
            os.environ.pop("ICGAN_VGG16_WEIGHTS")
        else:
            os.environ["ICGAN_VGG16_WEIGHTS"] = env
    # The same calls by hand, in the CLI's order.
    sampler, mcfg = inf.load_model_inference(flat, device=device)
    ds = dataset()
    sample = nchw(inf.make_conditioned_sampler(flat, sampler, mcfg, ds))
    ev = InceptionEvaluator(device=device)
    reals = cached_real_features(ds, ev, os.path.join(PREP_DIR, "feature_cache"), CALC_IMAGES,
                                 batch=CALC_BATCH)
    ref = np.load(os.path.join(PREP_DIR, moments_filename(PREP_RES)))
    common = dict(evaluator=ev, sample_fn=sample, num_images=CALC_IMAGES, batch=CALC_BATCH)
    want = {}
    for name, extra in (("fid50k_full", dict(ref_mu=ref["mu"], ref_sigma=ref["sigma"])),
                        ("kid50k_full", dict(real_features=reals)),
                        ("pr50k3_full", dict(real_features=reals)), ("is50k", {})):
        want.update(calc_metric(name, **common, **extra))
    g = sampler.module
    feature_fn = make_lpips_feature_fn(vgg_path, device=device)
    reset_peak()
    want.update(calc_metric(
        "ppl2_wend", g_synthesize=lambda ws, generator=None: g.synthesize(
            ws, noise_mode="random", generator=generator),
        map_ws=lambda z, feats=None: g.map_ws(z, None, feats), z_dim=mcfg.z_dim,
        num_samples=PPL_SAMPLES, batch=CALC_BATCH, feature_fn=feature_fn, device=device,
        cond_sampler=lambda b: {"feats": torch.as_tensor(
            ds.sample_conditioning_instance_balance(b)[1], device=device)}))
    ppl_peak = peak_gib()
    delta = _rel_delta(got, want)
    # LPIPS on the card against the CPU: 8 pairs of the G's images.
    z = torch.randn((16, mcfg.z_dim), generator=torch.Generator(device=device).manual_seed(96),
                    device=device)
    pair = sampler(z, None, torch.as_tensor(feats[:16]), device_output=True).permute(0, 3, 1, 2)
    card = LPIPSEvaluator(vgg_path, device=device).distance(pair[:8], pair[8:]).cpu()
    cpu = LPIPSEvaluator(vgg_path, device="cpu").distance(pair[:8].cpu(), pair[8:].cpu())
    lpips_rel = float(((card - cpu).abs() / cpu.abs()).max())
    records = sorted(os.listdir(flat["run_dir"]))
    if delta > CLI_REL or got["ppl_distance"] != "lpips" or launches["B4"] == 0 \
            or launches["B1"] or lpips_rel > 1e-4 \
            or records != sorted(f"metric-{m}.jsonl" for m in CALC_METRICS):
        raise AssertionError(f"calc_metrics: max rel |Δ| {delta:.3g} against direct calls, "
                             f"launches {launches}, LPIPS card/CPU {lpips_rel:.3g}, "
                             f"records {records}")
    log_card(f"cli/calc_metrics.py ({mcfg.img_resolution}^2 StyleGAN2 snapshot, h_dim "
             f"{mcfg.h_dim}; {','.join(CALC_METRICS)} at {CALC_IMAGES} images, batch "
             f"{CALC_BATCH}, PPL {PPL_SAMPLES} samples with LPIPS from a VGG16 file via "
             f"$ICGAN_VGG16_WEIGHTS; dataset in memory): {secs:.2f} s end to end with the "
             f"load; " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()
                                   if not isinstance(v, str))
             + f"; max rel |Δ| against direct calc_metric calls {delta:.2e}; PPL peak "
             f"{ppl_peak:.2f} GiB; LPIPS card vs CPU f32 on 8 pairs: max rel {lpips_rel:.2e}; "
             f"B4 launches {launches['B4']}")
    return dict(calc_s=secs, calc_launches=launches["B4"], calc_delta=delta,
                ppl_peak_gib=ppl_peak, lpips_rel=lpips_rel)


def phase_prepare_and_eval_clis(device) -> dict:
    """Phase 17: data preparation's cores (features, k-NN, k-means, moments)
    at ImageNet-LT's bank size and both eval CLIs, each held to float64 or to
    direct calls; B1 counted on ``cli/test.py``'s path, B4 on
    ``cli/calc_metrics.py``'s."""
    shutil.rmtree(PREP_DIR, ignore_errors=True)
    os.makedirs(PREP_DIR)
    t0 = time.perf_counter()
    try:
        out = _prepare_features(device)
        imgs, feats = out.pop("imgs"), out.pop("feats")
        feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
        torch.cuda.empty_cache()
        out.update(_knn_and_kmeans(device))
        torch.cuda.empty_cache()
        out.update(_moments(device, imgs))
        out.update(_test_cli(device, imgs, feats))
        torch.cuda.empty_cache()
        out.update(_calc_metrics_cli(device, imgs, feats))
    finally:
        shutil.rmtree(PREP_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 17 took {out['phase_s']:.1f} s, its checks included")
    return out


# --- int8 serving and the exported sampler (phase 18) ---------------------------------------
# Phase 5's cell (the 256² ch96 IC-GAN G, attention at 64², σ folded, batch
# 128), phase 15's BigGAN-deep G and phase 12's StyleGAN2 model, each handed
# over as a user would (an upstream .pth bundle, a network snapshot) and
# loaded by load_model_inference with and without quantize_serving: 64
# calibration images drawn as the JAX CLI draws them, the features from a
# stored-features file.  Bars: int8 images against the float ones below the
# JAX tests' bars (mean relative 0.1 for BigGAN, 0.15 for StyleGAN2's CLI);
# an exported program's images against its live sampler's within 1e-5, its
# launches equal to the live sampler's.
Q_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_int8")
Q_STORED = 1000                    # rows of the stored-features file
Q_SG2_BATCH = 32                   # load_model_inference's default batch
Q_DRIFT_BAR = {"biggan": 0.1, "stylegan2": 0.15}
EXPORT_ATOL = 1e-5


def _drift(got, want) -> float:
    """mean|Δ| / mean|float|, the int8 images against the float ones."""
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


def _alternating_ips(samplers: dict, args, batch: int, rounds: int = 3) -> dict:
    """img/s of each sampler (name → fn), median of ``2·rounds`` passes taken
    in turns (a, b, b, a, ...) after one warm-up each, so that the card's
    state drifts alike for all; each pass ends in a synchronize."""
    times = {k: [] for k in samplers}
    for fn in samplers.values():
        fn(*args, device_output=True)
    sync()
    names = list(samplers)
    for _ in range(rounds):
        for name in names + names[::-1]:
            t0 = time.perf_counter()
            samplers[name](*args, device_output=True)
            sync()
            times[name].append(time.perf_counter() - t0)
    return {k: batch / statistics.median(v) for k, v in times.items()}


def _launches(fn, *args) -> dict:
    """``counts()`` over exactly one call of ``fn(*args, device_output=True)``."""
    reset_counts()
    out = fn(*args, device_output=True)
    sync()
    return out, counts()


def _pth_bundle(directory, state_dict, flat):
    """An upstream .pth bundle: G_ema.pth (upstream names, so no standing
    counters) and its config in state_dict.pth."""
    os.makedirs(directory)
    torch.save({k: v.cpu() for k, v in state_dict.items() if not k.endswith("accum_counter")},
               os.path.join(directory, "G_ema.pth"))
    torch.save({"config": flat}, os.path.join(directory, "state_dict.pth"))
    return directory


def _int8_conv_cases(g) -> list:
    """Each distinct int8 conv of a quantized BigGAN G, from one batch-1
    forward: (label, input shape (C, H, W), int8 kernel, padding, the bf16
    kernel of the float layer, up2x)."""
    from ic_gan_tpu_torch.models.layers import SNConv

    seen = {}

    def hook(name, m):
        def record(_, args):
            if name not in seen:
                seen[name] = (tuple(args[0].shape[1:]), m)
        return record

    handles = [m.register_forward_pre_hook(hook(n, m)) for n, m in g.named_modules()
               if (isinstance(m, SNConv) and m.quantized) or isinstance(m, SelfAttention)]
    z = torch.zeros((1, g.cfg.effective_dim_z), device=g.output_layer[2].weight.device)
    with torch.inference_mode():
        g(z, None, torch.zeros((1, g.cfg.instance_sz), device=z.device))
    for h in handles:
        h.remove()
    cases, keys = [], set()
    for name, (shape, m) in seen.items():
        if isinstance(m, SelfAttention):
            convs = (m.theta, m.phi, m.g)
            if not m.theta.quantized:
                continue
            case = (f"{name}.theta|phi|g (fused 1x1)", shape, torch.cat([c.qkernel for c in convs]),
                    0, torch.cat([c.weight for c in convs]), False)
        else:
            case = (name, shape, m.qkernel, m.padding, m.weight, m.up2x)
        key = (shape, tuple(case[2].shape))
        if key not in keys:
            keys.add(key)
            cases.append(case)
    return cases


def _conv_route_case(label, shape, qk, padding, w, up2x, batch, device, gen) -> dict:
    """The int8 route (im2col and ``torch._int_mm``) against its plain
    version (float64, exact) on the card, bit for bit, each phase of an
    up2x conv with its own padding; its time against the bf16 cuDNN conv of
    the same shape (the float layer's: an up2x conv as its four phase
    convs)."""
    from ic_gan_tpu_torch.ops.int8_conv import conv2d_int8, conv2d_int8_ref
    from ic_gan_tpu_torch.ops.resample import _PHASE_OFFSETS, conv3x3_nearest_up

    xq = torch.randint(-127, 128, (batch,) + shape, generator=gen, device=device,
                       dtype=torch.int8)
    xb, wb = xq.to(torch.bfloat16), w.to(torch.bfloat16)
    if up2x:
        parts = [(qk[i], (1 - di, di, 1 - dj, dj)) for i, (di, dj) in enumerate(_PHASE_OFFSETS)]
        bf16 = lambda: conv3x3_nearest_up(xb, wb)  # noqa: E731
    else:
        parts = [(qk, padding)]
        bf16 = lambda: F.conv2d(xb, wb, padding=padding)  # noqa: E731
    exact = True
    for k, pad in parts:
        got, want = conv2d_int8(xq, k, pad), conv2d_int8_ref(xq, k, pad)
        exact &= bool(torch.equal(got, want)) and got.dtype == torch.int32
        del got, want
    route = lambda: [conv2d_int8(xq, k, pad) for k, pad in parts]  # noqa: E731
    ms, bf16_ms = cuda_ms(route, reps=3, warmup=1), cuda_ms(bf16, reps=3, warmup=1)
    n_out = batch * qk.shape[-4] * math.prod(shape[1:]) * (4 if up2x else 1)
    ops = 2 * n_out * math.prod(qk.shape[-3:])
    out = dict(label=label, input=[batch, *shape], qkernel=list(qk.shape), exact=exact,
               int8_ms=ms, bf16_cudnn_ms=bf16_ms, int8_tops=ops / ms / 1e9,
               bf16_tflops=ops / bf16_ms / 1e9)
    log_card(f"int8 conv {label}: input {out['input']}, kernel {out['qkernel']}: int32 sums "
             f"{'equal to the plain version bit for bit' if exact else 'DIFFER'}; "
             f"im2col + _int_mm {ms:.3f} ms ({out['int8_tops']:.1f} TOP/s) against the bf16 "
             f"cuDNN conv {bf16_ms:.3f} ms ({out['bf16_tflops']:.1f} TFLOP/s)")
    if not exact:
        raise AssertionError(f"int8 conv {label}: the card's route differs from the plain version")
    return out


def _export_case(label, sampler, args, kernel, device, profile=False) -> dict:
    """``export_sampler`` of a live sampler's module, loaded back: the
    artifact's MiB, export and load seconds, the loaded program's images
    against the live sampler's, its ``kernel`` launches a batch (which must
    be the live sampler's, and not 0), and both samplers' img/s in turns."""
    from ic_gan_tpu_torch.io.deploy import export_sampler, load_exported_sampler

    sync()
    t0 = time.perf_counter()
    data = export_sampler(sampler.module, sampler.batch_size, device=device,
                          **sampler.apply_kwargs)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_exported_sampler(data)
    sync()
    load_s = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in loaded.program.graph.nodes
                  if "ic_gan_tpu" in str(n.target)})
    got, launched = _launches(loaded, *args)
    want, live = _launches(sampler, *args)
    max_d = (got - want).abs().max().item()
    ips = _alternating_ips({"live": sampler, "loaded": loaded}, args, sampler.batch_size, 2)
    if profile:
        phase_profile(f"one batch of the loaded {label} program",
                      lambda: loaded(*args, device_output=True))
    out = dict(label=label, mib=len(data) / 2 ** 20, export_s=export_s, load_s=load_s,
               ops=ops, launches=launched[kernel], live_launches=live[kernel],
               max_abs_delta=max_d, img_per_s=ips["loaded"], live_img_per_s=ips["live"])
    log_card(f"exported {label}: {out['mib']:.1f} MiB, export {export_s:.2f} s, load "
             f"{load_s:.2f} s; ops in the program {ops}; {kernel} launches a batch "
             f"{launched[kernel]} (live {live[kernel]}); max|Δ| against the live sampler "
             f"{max_d:.3g}; {ips['loaded']:.2f} img/s against the live {ips['live']:.2f}")
    if launched[kernel] == 0 or launched != live or max_d > EXPORT_ATOL \
            or got.shape != want.shape:
        raise AssertionError(f"exported {label}: launches {launched} against {live}, "
                             f"max|Δ| {max_d}")
    del loaded, data
    return out


def _int8_biggan(device, flat, bank, cfg_kind, main_ips=None, profile=False) -> dict:
    """One BigGAN backbone (``cfg_kind`` "biggan" or "deep") through
    load_model_inference, bf16 and int8 (deploy_bf16); the first also with
    ``skip_attention=False`` and the conv shapes; both exported.  With
    ``profile``, device-time breakdowns of one bf16 and one int8 batch."""
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.io import quant
    from ic_gan_tpu_torch.io.deploy import set_compute_dtype

    flat = dict(flat, deploy_bf16=True, batch_size=SAMPLER_BATCH, stored_features=bank)
    inf.load_generator(flat, device=device)        # a first read of the bundle, untimed
    sync()
    t0 = time.perf_counter()
    f16, mcfg = inf.load_model_inference(flat, device=device)
    sync()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q8, _ = inf.load_model_inference(dict(flat, quantize_serving=True), device=device)
    sync()
    q_load_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(100)
    z = torch.randn((SAMPLER_BATCH, mcfg.effective_dim_z), generator=gen, device=device)
    label = (torch.randint(0, mcfg.n_classes, (SAMPLER_BATCH,), generator=gen, device=device)
             if mcfg.class_cond else None)
    # Conditioning from the stored instances, as a user samples (the int8
    # ranges were calibrated on them).
    rows = torch.randint(0, Q_STORED, (SAMPLER_BATCH,), generator=gen, device=device)
    feats = torch.as_tensor(np.load(bank), device=device)[rows] if mcfg.instance_cond else None
    args = (z, label, feats)
    ref, ref_launches = _launches(f16, *args)
    reset_peak()
    img, launches = _launches(q8, *args)
    peak = peak_gib()
    with torch.inference_mode():
        direct = q8.module(z, label, feats).permute(0, 2, 3, 1)
    n_q = sum(k.endswith(".qkernel") for k in q8.module.state_dict())
    drift = _drift(img, ref)
    ips = _alternating_ips({"bf16": f16, "int8": q8}, args, SAMPLER_BATCH)
    out = dict(load_s=load_s, int8_load_s=q_load_s, calibration_s=q_load_s - load_s,
               int8_convs=n_q, drift=drift, peak_gib=peak, launches=launches["B1"],
               bf16_launches=ref_launches["B1"], img_per_s=ips["int8"],
               bf16_img_per_s=ips["bf16"], direct_equal=bool(torch.equal(img, direct)))
    ok = (img.shape == ref.shape and bool(torch.isfinite(img).all()) and out["direct_equal"]
          and launches == dict(B1=1, B2=0, B3=0, B4=0, B4bwd=0) and 0 < drift < Q_DRIFT_BAR[
              "biggan"] and n_q > 0)
    log_card(f"int8 {cfg_kind} sampler (load_model_inference, quantize_serving, deploy_bf16, "
             f"batch {SAMPLER_BATCH}, 64 calibration images): {n_q} int8 convs; load "
             f"{q_load_s:.2f} s against {load_s:.2f} s without int8 (calibration and "
             f"quantization {q_load_s - load_s:.2f} s); {ips['int8']:.2f} img/s against bf16 "
             f"{ips['bf16']:.2f} img/s in turns" + (f" (phase 5's bf16 {main_ips:.2f})" if
                                                    main_ips else "")
             + f"; drift mean|Δ|/mean|bf16| {drift:.5f}; peak memory {peak:.2f} GiB; "
             f"launches {launches}; direct call "
             f"{'bit for bit' if out['direct_equal'] else 'DIFFERS'}")
    if not ok:
        raise AssertionError(f"int8 {cfg_kind} sampler: {out}")
    if profile:
        for name, fn in (("bf16", f16), ("int8", q8)):
            phase_profile(f"one {name} {cfg_kind} sampler batch of {SAMPLER_BATCH}",
                          lambda fn=fn: fn(*args, device_output=True))
    exports = [_export_case(f"{cfg_kind} bf16 G", f16, args, "B1", device)]
    if cfg_kind == "biggan":
        exports.append(_export_case(f"{cfg_kind} int8 G", q8, args, "B1", device))
        # skip_attention=False once: the attention's θ/φ/g (fused) and o in
        # int8 too, calibrated on the same draws as load_model_inference's.
        del f16
        torch.cuda.empty_cache()
        g, _ = inf.load_generator(flat, device=device)
        fold_spectral_norm(g)
        rng = np.random.RandomState(0)
        zc = torch.as_tensor(rng.randn(64, mcfg.effective_dim_z), dtype=torch.float32,
                             device=device)
        bank_rows = np.load(bank)
        fc = torch.as_tensor(bank_rows[rng.randint(0, len(bank_rows), 64)], device=device)
        sync()
        t0 = time.perf_counter()
        quant.quantize_variables(g, zc, None, fc, skip_attention=False)
        sync()
        cal_s = time.perf_counter() - t0
        cast_params(set_compute_dtype(g, torch.bfloat16), torch.bfloat16)
        full = make_sampler(g, batch_size=SAMPLER_BATCH, device=device)
        img_full, launches_full = _launches(full, *args)
        drift_full = _drift(img_full, ref)
        ips_full = _alternating_ips({"int8": q8, "int8 attention too": full}, args,
                                    SAMPLER_BATCH)
        out["skip_attention_false"] = dict(calibration_s=cal_s, drift=drift_full,
                                           launches=launches_full["B1"],
                                           img_per_s=ips_full["int8 attention too"],
                                           default_img_per_s=ips_full["int8"])
        log_card(f"int8 biggan sampler with skip_attention=False (quantize_variables, "
                 f"calibration {cal_s:.2f} s): {ips_full['int8 attention too']:.2f} img/s "
                 f"against the default int8's {ips_full['int8']:.2f} in turns; drift "
                 f"{drift_full:.5f}; launches {launches_full}")
        if not (0 < drift_full < Q_DRIFT_BAR["biggan"]) or launches_full["B1"] != 1:
            raise AssertionError(f"int8 attention: drift {drift_full}, {launches_full}")
        out["convs"] = [_conv_route_case(*case, SAMPLER_BATCH, device, gen)
                        for case in _int8_conv_cases(g)]
        del g, full
    out["exports"] = exports
    del q8, ref, img, direct
    torch.cuda.empty_cache()
    return out


def _int8_stylegan2(device, bank, profile=False) -> dict:
    """Phase 12's StyleGAN2 model as a network snapshot through
    load_model_inference: float, int8 static per-channel and int8 with
    ``quantize_dynamic``; B4 counted; the static one exported; one composite
    up=2 conv through the int8 route.  With ``profile``, device-time
    breakdowns of one float and one int8 batch, and of one batch of the
    loaded int8 program."""
    from ic_gan_tpu_torch.cli import inference as inf

    base = dict(backbone="stylegan2", network_pkl=_sg2_snapshot(device, Q_DIR),
                batch_size=Q_SG2_BATCH, stored_features=bank)
    samplers = {}
    load_s = {}
    for name, kw in (("float", {}), ("int8", dict(quantize_serving=True)),
                     ("int8 dynamic", dict(quantize_serving=True, quantize_dynamic=True))):
        sync()
        t0 = time.perf_counter()
        samplers[name] = inf.load_model_inference(dict(base, **kw), device=device)[0]
        sync()
        load_s[name] = time.perf_counter() - t0
    cfg = samplers["float"].model_cfg
    gen = torch.Generator(device=device).manual_seed(101)
    rows = torch.randint(0, Q_STORED, (Q_SG2_BATCH,), generator=gen, device=device)
    args = (torch.randn((Q_SG2_BATCH, cfg.z_dim), generator=gen, device=device), None,
            torch.as_tensor(np.load(bank), device=device)[rows])
    ref, ref_launches = _launches(samplers["float"], *args)
    out = dict(load_s=load_s)
    for name in ("int8", "int8 dynamic"):
        reset_peak()
        img, launches = _launches(samplers[name], *args)
        drift = _drift(img, ref)
        out[name] = dict(drift=drift, launches=launches["B4"], peak_gib=peak_gib())
        if not bool(torch.isfinite(img).all()) or not 0 < drift < Q_DRIFT_BAR["stylegan2"] \
                or launches != ref_launches or launches["B4"] == 0:
            raise AssertionError(f"int8 stylegan2 ({name}): drift {drift}, launches "
                                 f"{launches} against {ref_launches}")
    ips = _alternating_ips(samplers, args, Q_SG2_BATCH)
    for name in ("int8", "int8 dynamic"):
        out[name]["img_per_s"] = ips[name]
    out.update(float_img_per_s=ips["float"], float_launches=ref_launches["B4"])
    log_card(f"int8 stylegan2 sampler ({cfg.img_resolution}^2, h_dim {cfg.h_dim}, "
             f"load_model_inference at batch {Q_SG2_BATCH}, noise const): float (bf16 from "
             f"32^2 as configured) {ips['float']:.2f} img/s; int8 static per-channel "
             f"{ips['int8']:.2f} img/s, drift {out['int8']['drift']:.5f}; int8 dynamic "
             f"{ips['int8 dynamic']:.2f} img/s, drift {out['int8 dynamic']['drift']:.5f}; B4 "
             f"launches a batch {ref_launches['B4']} in each; loads (calibration included) "
             + ", ".join(f"{k} {v:.2f} s" for k, v in load_s.items()))
    res = cfg.img_resolution
    layer = getattr(samplers["int8"].module.synthesis, f"b{res}").conv0
    out["composite_conv"] = _conv_route_case(
        f"synthesis.b{res}.conv0 (StyleGAN2 composite up=2)",
        (layer.weight.shape[1], res // 2, res // 2), layer.qkernel, 1, layer.qkernel, False,
        Q_SG2_BATCH, device, gen)
    if profile:
        for name in ("float", "int8"):
            phase_profile(f"one {name} stylegan2 sampler batch of {Q_SG2_BATCH}",
                          lambda name=name: samplers[name](*args, device_output=True))
    out["export"] = _export_case("stylegan2 int8 G", samplers["int8"], args, "B4", device,
                                 profile)
    del samplers
    torch.cuda.empty_cache()
    return out


def phase_int8_and_export(device, main_ips, deep_unfolded, profile=False) -> dict:
    """Phase 18: int8 serving for the three backbones and their exported
    samplers, each against its float sampler and its live sampler."""
    shutil.rmtree(Q_DIR, ignore_errors=True)
    os.makedirs(Q_DIR)
    t0 = time.perf_counter()
    try:
        bank = os.path.join(Q_DIR, "stored_features.npy")
        feats = np.random.RandomState(102).randn(Q_STORED, 2048).astype(np.float32)
        np.save(bank, feats / np.linalg.norm(feats, axis=1, keepdims=True))
        cfg = BigGANConfig(**MAIN_G)
        g = Generator(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
        set_gamma(g)
        flat = dict(INFERENCE_FLAT, pth_dir=_pth_bundle(os.path.join(Q_DIR, "biggan"),
                                                        g.state_dict(), INFERENCE_FLAT))
        del g
        out = dict(biggan=_int8_biggan(device, flat, bank, "biggan", main_ips, profile))
        deep_flat = dict(model="BigGANdeep", **DEEP_MODEL)
        deep_flat = dict(deep_flat, pth_dir=_pth_bundle(os.path.join(Q_DIR, "deep"),
                                                        deep_unfolded, deep_flat))
        out["deep"] = _int8_biggan(device, deep_flat, bank, "deep")
        out["stylegan2"] = _int8_stylegan2(device, bank, profile)
    finally:
        shutil.rmtree(Q_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 took {out['phase_s']:.1f} s, its checks included")
    return out



# --- the remaining CLIs and the pretrained-weight paths (phase 19) ------------------------
# The sheets of cli/visualize.py at upstream's sizes (an 8 × 8 sample sheet,
# interpolation sheets of 4 rows of 8 midpoints, style mixing over
# style_mixing.py's seeds, a random sheet of 64) on phase 5's IC-GAN G and
# phase 12's StyleGAN2 G; the projector on phase 12's G (10,000 w
# samples); CLIP ViT-B/32 from a seed over phase 5's G in
# f32 with the colab's population (50) and augmentations (64); a synthetic
# TFHub BigGAN-256 dump (ch 96, dim_z 140, attention at 128²) behind the
# sampler at batch 128; a TF1 GraphDef with the official fetch names over
# 1,024 images.  Cut to keep the phase near 90 s: the projector's steps and
# the search's iterations (upstream 100 and 100).
APPS_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_apps")
SHEET_ROWS, SHEET_COLS = 8, 8
INTERP_ROWS, INTERP_MIDPOINTS = 4, 8
VIS_BATCH = 8
MIX_SEEDS = dict(row_seeds="85,100,75,458,1500", col_seeds="55,821,1789,293", col_styles="0-6")
RANDOM_SHEET, SG2_VIS_BATCH = 64, 16
PROJECT_STEPS, PROJECT_W_AVG = 200, 10000
CLIP_POP, CLIP_AUGS = 50, 64
CLIP_CMA_ITERS, CLIP_TERMINAL_ITERS, CLIP_ADAM_ITERS = 3, 2, 2
TFHUB_RES = 256
TF1_IMAGES, TF1_BATCH, TF1_CHECK_IMAGES, TF1_REL = 1024, 100, 4, 1e-3
PHASE19_CUTS = (
    f"projector: {PROJECT_STEPS} of upstream's 1,000 steps",
    f"CLIP-guided search: CMA-ES + terminal Adam for {CLIP_CMA_ITERS} + {CLIP_TERMINAL_ITERS} "
    f"iterations and Adam for {CLIP_ADAM_ITERS} (the colab's 100 + 100)",
    "CLIP, the TFHub dump and the TF1 graph: random weights from a seed (no published "
    "file is in the repository)",
    "TF1 graph: a 2048-wide stack of 8 convolutions over the official names and ops, not "
    "the 2015 Inception's 94",
    "TFHub dump: an .npz of the dump's names (the card's machine has no h5py)",
)


def _check_equal(name, got, want):
    if not torch.equal(torch.as_tensor(got), torch.as_tensor(want)):
        d = (torch.as_tensor(got).float() - torch.as_tensor(want).float()).abs().max().item()
        raise AssertionError(f"{name}: not bit for bit against direct calls (max|Δ| {d:.3e})")


def _png_equal(name, path, images, nrow):
    """The CLI's PNG against ``save_image_grid`` of the direct images."""
    from PIL import Image

    from ic_gan_tpu_torch.cli.inference import save_image_grid

    direct = os.path.join(APPS_DIR, "direct.png")
    save_image_grid(np.asarray(images), direct, nrow=nrow)
    if not np.array_equal(np.asarray(Image.open(path)), np.asarray(Image.open(direct))):
        raise AssertionError(f"{name}: the CLI's PNG differs from the direct calls'")


def _stored_bank(n, seed) -> str:
    feats = np.random.RandomState(seed).randn(n, 2048).astype(np.float32)
    path = os.path.join(APPS_DIR, f"stored_{seed}.npy")
    np.save(path, feats / np.linalg.norm(feats, axis=1, keepdims=True))
    return path


def _biggan_sheets(device, bank) -> dict:
    """cli/visualize.py's sheets on phase 5's G from an upstream .pth bundle,
    folded bf16: the 8 × 8 sample sheet from stored instances and the
    interpolation sheets (z and features, z alone, features alone), each
    against direct sampler calls bit for bit; B1 once a batch."""
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli import visualize as vis

    g = Generator(BigGANConfig(**MAIN_G), device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    set_gamma(g)
    flat = dict(INFERENCE_FLAT, pth_dir=_pth_bundle(os.path.join(APPS_DIR, "biggan"),
                                                    g.state_dict(), INFERENCE_FLAT),
                deploy_bf16=True, batch_size=VIS_BATCH, stored_features=bank,
                sample_sheets=True, sample_interps=True, num_conditionings_gen=SHEET_ROWS,
                num_imgs_gen=SHEET_COLS, num_rows=INTERP_ROWS, num_midpoints=INTERP_MIDPOINTS,
                seed=19, out_dir=os.path.join(APPS_DIR, "sheets"))
    del g
    argv = _flat_argv(os.path.join(APPS_DIR, "vis.json"), flat, device)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    written = vis.main(argv)
    sync()
    secs, launches = time.perf_counter() - t0, counts()
    steps = INTERP_MIDPOINTS + 2
    batches = SHEET_ROWS * math.ceil(SHEET_COLS / VIS_BATCH) \
        + 3 * math.ceil(INTERP_ROWS * steps / VIS_BATCH)
    if launches["B1"] != batches or launches["B1"] != sum(launches.values()):
        raise AssertionError(f"visualize: launches {launches} for {batches} batches")

    sampler, mcfg = inf.load_model_inference(flat, device=device)
    feats = np.load(bank)
    dim_z, gen = mcfg.effective_dim_z, torch.Generator().manual_seed(19)
    direct = np.concatenate([sampler(torch.randn((SHEET_COLS, dim_z), generator=gen),
                                     None, np.repeat(feats[i][None], SHEET_COLS, 0))
                             for i in range(SHEET_ROWS)])
    sheet = vis.sample_sheet(sampler, dim_z, [(None, feats[i]) for i in range(SHEET_ROWS)],
                             SHEET_COLS, seed=19)
    _check_equal("sample sheet", sheet, direct)
    _png_equal("sample sheet", written[0], direct, SHEET_COLS)
    t = torch.linspace(0.0, 1.0, steps)[None, :, None]
    for path, fix_z, fix_feats in zip(written[1:], (False, False, True), (False, True, False)):
        gen = torch.Generator().manual_seed(19)
        z_a = torch.randn((INTERP_ROWS, 1, dim_z), generator=gen)
        zs = z_a.expand(-1, steps, -1) if fix_z else \
            z_a + (torch.randn((INTERP_ROWS, 1, dim_z), generator=gen) - z_a) * t
        idx = torch.randint(0, len(feats), (INTERP_ROWS, 2), generator=gen)
        f_a, f_b = (torch.from_numpy(feats)[idx[:, i]][:, None] for i in (0, 1))
        fs = f_a.expand(-1, steps, -1) if fix_feats else f_a + (f_b - f_a) * t
        direct = sampler(zs.reshape(-1, dim_z), None, fs.reshape(INTERP_ROWS * steps, -1))
        sheet = vis.interp_sheet(sampler, dim_z, INTERP_MIDPOINTS, INTERP_ROWS, fix_z,
                                 fix_feats, feats, seed=19)
        _check_equal(os.path.basename(path), sheet, direct)
        _png_equal(os.path.basename(path), path, direct, steps)
    log(f"visualize (IC-GAN {mcfg.resolution}^2 ch{mcfg.G_ch}, deploy_bf16, batch {VIS_BATCH}): "
        f"{', '.join(os.path.basename(p) for p in written)} in {secs:.2f} s with the load; "
        f"{SHEET_ROWS} x {SHEET_COLS} sample sheet and 3 interpolation sheets of "
        f"{INTERP_ROWS} x {steps} equal direct sampler calls bit for bit (floats and PNGs); "
        f"B1 launches {launches['B1']} for {batches} batches")
    return dict(s=secs, launches=launches["B1"])


def _sg2_sheets(device, pkl, bank) -> dict:
    """cli/visualize.py's style mixing (style_mixing.py's seeds) and random
    sheet on phase 12's StyleGAN2 G, each against direct calls bit for bit;
    B4 counted."""
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli import visualize as vis

    flat = dict(backbone="stylegan2", network_pkl=pkl, stored_features=bank,
                batch_size=SG2_VIS_BATCH, num_samples=RANDOM_SHEET, seed=19,
                out_dir=os.path.join(APPS_DIR, "sg2_sheets"), **MIX_SEEDS)
    out = {}
    for mode in ("style_mixing", "random"):
        argv = _flat_argv(os.path.join(APPS_DIR, f"{mode}.json"), dict(flat, mode=mode), device)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        out[mode] = (vis.main(argv)[0], time.perf_counter() - t0, counts())
    sampler, cfg = inf.load_model_inference(flat, device=device)
    g, feats = sampler.module, np.load(bank)
    rows, cols = (vis._parse_num_list(MIX_SEEDS[k], None) for k in ("row_seeds", "col_seeds"))
    styles = vis._parse_num_list(MIX_SEEDS["col_styles"], None)
    seeds = list(dict.fromkeys(rows + cols))
    with torch.inference_mode():
        zs = torch.stack([torch.randn((cfg.z_dim,), generator=torch.Generator().manual_seed(s))
                          for s in seeds]).to(device)
        ws = g.map_ws(zs, None, torch.from_numpy(feats[0]).to(device).expand(len(seeds), -1))
        mixed = []
        for r in rows:
            for c in cols:
                w = ws[seeds.index(r)].clone()
                w[styles] = ws[seeds.index(c)][styles]
                mixed.append(w)
        direct = g.synthesize(torch.stack(mixed), noise_mode="const").permute(0, 2, 3, 1)
    _png_equal("style mixing", out["style_mixing"][0], direct.float().cpu().numpy(), len(cols))
    idx = np.random.RandomState(19).randint(0, len(feats), RANDOM_SHEET)
    z = torch.randn((RANDOM_SHEET, cfg.z_dim), generator=torch.Generator().manual_seed(19))
    _png_equal("random sheet", out["random"][0], sampler(z, None, feats[idx]), 8)
    b4 = {m: o[2]["B4"] for m, o in out.items()}
    if min(b4.values()) == 0:
        raise AssertionError(f"StyleGAN2 sheets launched {b4} B4 kernels")
    log(f"visualize (StyleGAN2 {cfg.img_resolution}^2, h_dim {cfg.h_dim}): style mixing rows "
        f"{MIX_SEEDS['row_seeds']} x cols {MIX_SEEDS['col_seeds']}, styles "
        f"{MIX_SEEDS['col_styles']}: {out['style_mixing'][1]:.2f} s; random sheet of "
        f"{RANDOM_SHEET} at batch {SG2_VIS_BATCH}: {out['random'][1]:.2f} s (the load "
        f"included); both PNGs equal direct calls; B4 launches {b4}")
    return dict(launches=sum(b4.values()), s={m: o[1] for m, o in out.items()})


def _projector(device, pkl, bank, profile=False) -> dict:
    """``project`` on phase 12's G toward one of its own images, LPIPS with
    VGG16 from a seed, at upstream's steps: ms a step, the loss falling, B4
    forward and backward launches a step."""
    from ic_gan_tpu_torch.cli import inference as inf
    from ic_gan_tpu_torch.cli.projector import project
    from ic_gan_tpu_torch.eval.metrics import make_lpips_feature_fn

    g, cfg = inf.load_generator(dict(backbone="stylegan2", network_pkl=pkl), device)
    feats = torch.from_numpy(np.load(bank)[1]).to(device)
    with torch.no_grad():
        z = torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(191)).to(device)
        target = g(z, None, feats[None], noise_mode="const")[0].permute(1, 2, 0).clamp(-1, 1)
    feature_fn = make_lpips_feature_fn(device=device)
    reset_counts()
    reset_peak()
    sync()
    t0 = time.perf_counter()
    w, hist = project(g, target, cond_feats=feats, num_steps=PROJECT_STEPS,
                      w_avg_samples=PROJECT_W_AVG, feature_fn=feature_fn, seed=19)
    sync()
    secs, launches = time.perf_counter() - t0, counts()
    if not (np.all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"projector: loss {hist[0]} → {hist[-1]}")
    if launches["B4"] < PROJECT_STEPS or launches["B4bwd"] < PROJECT_STEPS:
        raise AssertionError(f"projector launches {launches}")
    per = {k: launches[k] / PROJECT_STEPS for k in ("B4", "B4bwd")}
    if profile:
        phase_profile("20 projector steps (with the w statistics of 10,000 samples)",
                      lambda: project(g, target, cond_feats=feats, num_steps=20,
                                      w_avg_samples=PROJECT_W_AVG, feature_fn=feature_fn))
    log_card(f"projector (StyleGAN2 {cfg.img_resolution}^2, LPIPS VGG16 from a seed, "
             f"{PROJECT_STEPS} steps, "
             f"{PROJECT_W_AVG} w samples): {1e3 * secs / PROJECT_STEPS:.2f} ms a step "
             f"({secs:.2f} s with the w statistics and the target's features); loss "
             f"{hist[0]:.4f} → {hist[len(hist) // 2]:.4f} → {hist[-1]:.4f}; B4 forward "
             f"{per['B4']:.2f} and backward {per['B4bwd']:.2f} launches a step (the mapping of "
             f"the w samples included); peak memory {peak_gib():.2f} GiB; w {tuple(w.shape)}")
    return dict(ms_per_step=1e3 * secs / PROJECT_STEPS, loss=(hist[0], hist[-1]),
                launches=launches, per_step=per)


def _synthetic_bpe():
    """A BPE table whose merges spell the prompt's words (OpenAI's table is
    not in the repository) and the prompt."""
    from ic_gan_tpu_torch.data.tokenizer import SimpleTokenizer

    prompt = "A red dragon over a green field"
    merges = []
    for word in ("red", "dragon", "over", "green", "field"):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
    return SimpleTokenizer(merges), prompt


def _clip_guided(device, weights, bank, profile=False) -> dict:
    """CLIP ViT-B/32 from a seed over phase 5's G folded in f32: the colab's
    search (population 50, 64 augmentations) as CMA-ES + terminal Adam and
    as Adam; ms and B1/B2 launches per iteration of each phase."""
    from ic_gan_tpu_torch.cli.clip_guided import clip_guided_search
    from ic_gan_tpu_torch.data.tokenizer import tokenize
    from ic_gan_tpu_torch.models.clip import CLIP, vit_b32

    clip = CLIP(vit_b32(), device=device,
                generator=torch.Generator(device=device).manual_seed(192)).requires_grad_(False)
    tok, prompt = _synthetic_bpe()
    tokens = tokenize(prompt, tok, clip.cfg.context_length)
    with torch.no_grad():
        text = clip.encode_text(torch.from_numpy(tokens).to(device))
    cfg = BigGANConfig(**MAIN_G)
    g = fold_spectral_norm(skip_init(Generator, cfg, device=device))
    g.load_state_dict({k: v.to(device) for k, v in weights.items()})
    g.requires_grad_(False)
    feats = torch.from_numpy(np.load(bank)[2]).to(device)

    def generate(z):
        return g(z, None, feats.expand(z.shape[0], -1)).permute(0, 2, 3, 1)

    out = {}
    for optimizer, iters, terminal in (("CMA-ES + terminal Adam", CLIP_CMA_ITERS,
                                        CLIP_TERMINAL_ITERS), ("Adam", CLIP_ADAM_ITERS, 0)):
        marks = []

        def callback(i, losses, z_pop):
            sync()
            marks.append((time.perf_counter(), counts()))

        reset_counts()
        reset_peak()
        sync()
        marks.append((time.perf_counter(), counts()))
        res = clip_guided_search(generate, clip.encode_image, text, cfg.effective_dim_z,
                                 optimizer=optimizer, pop_size=CLIP_POP, iterations=iters,
                                 terminal_iterations=terminal, augmentations=CLIP_AUGS,
                                 clip_res=clip.cfg.image_resolution, seed=19, callback=callback)
        its = [dict(ms=1e3 * (b[0] - a[0]), B1=b[1]["B1"] - a[1]["B1"],
                    B2=b[1]["B2"] - a[1]["B2"]) for a, b in zip(marks, marks[1:])]
        best = [h["best"] for h in res["history"]]
        if not (np.all(np.isfinite(best)) and res["best_loss"] <= best[0]
                and np.isfinite(res["best_image"]).all()
                and res["best_image"].shape == (cfg.resolution, cfg.resolution, 3)):
            raise AssertionError(f"CLIP-guided {optimizer}: best {res['best_loss']}, {best}")
        phases = {"CMA-ES": its[:iters], "terminal Adam": its[iters:]} if terminal \
            else {"Adam": its}
        for name, rows in phases.items():
            if name != "CMA-ES" and any(r["B2"] == 0 for r in rows):
                raise AssertionError(f"CLIP-guided {name}: an iteration launched no B2")
            if any(r["B1"] == 0 for r in rows):
                raise AssertionError(f"CLIP-guided {name}: an iteration launched no B1")
        out[optimizer] = dict(phases={n: dict(ms=[r["ms"] for r in rows],
                                              B1=[r["B1"] for r in rows],
                                              B2=[r["B2"] for r in rows])
                                      for n, rows in phases.items()},
                              best=best, peak_gib=peak_gib())
        log_card(f"CLIP-guided {optimizer} (ViT-B/32 f32 from a seed, IC-GAN "
                 f"{cfg.resolution}^2 ch{cfg.G_ch} folded f32, population {CLIP_POP}, "
                 f"{CLIP_AUGS} augmentations): "
                 + "; ".join(f"{n}: ms an iteration " + ", ".join(f"{r['ms']:.1f}" for r in rows)
                             + ", B1 " + ", ".join(str(r["B1"]) for r in rows)
                             + ", B2 " + ", ".join(str(r["B2"]) for r in rows)
                             for n, rows in phases.items())
                 + f"; best loss by iteration {', '.join(f'{b:.4f}' for b in best)}, "
                 f"best {res['best_loss']:.4f} at iteration {res['best_iteration']}; peak "
                 f"memory {peak_gib():.2f} GiB")
    launches = {k: sum(sum(p[k]) for o in out.values() for p in o["phases"].values())
                for k in ("B1", "B2")}
    if profile:
        phase_profile(f"one CLIP-guided Adam iteration at population {CLIP_POP} (and the best "
                      f"image's forward)", lambda: clip_guided_search(
                          generate, clip.encode_image, text, cfg.effective_dim_z,
                          optimizer="Adam", pop_size=CLIP_POP, iterations=1,
                          augmentations=CLIP_AUGS, clip_res=clip.cfg.image_resolution, seed=19))
    log(f"tokenizer on a synthetic BPE table of {len(tok.bpe_ranks)} merges: {prompt!r} → "
        f"{tokens[0][:int(np.argmax(tokens[0])) + 1].tolist()}")
    return dict(searches=out, launches=launches)


def _tfhub_dump(resolution, ch, rng) -> dict:
    """A TFHub BigGAN variable dump with the release's names and shapes
    (``io/tfhub_import.py``'s inputs), weights from ``rng``."""
    from ic_gan_tpu_torch.io.tfhub_import import _GEOMETRY, tfhub_config

    geo, arch = _GEOMETRY[resolution], tfhub_config(resolution).replace(G_ch=ch).g_arch
    z_chunk = geo["dim_z"] // (geo["blocks"] + 1)
    cond, suff, gen_dir = 128 + z_chunk, "/ema_b999900", "module/Generator"
    d = {}

    def add(path, shape, ema=True, scale=0.05):
        d[f"{path}{suff if ema else ''}:0"] = (rng.standard_normal(shape, np.float32)
                                              * np.float32(scale))

    def sn(path, shape, bias=True):
        add(f"{path}/w", shape, scale=1.0 / np.sqrt(np.prod(shape[:-1])))
        add(f"{path}/u0", (1, shape[-1]), ema=False, scale=1.0)
        if bias:
            add(f"{path}/b", (shape[-1],))

    for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
        blk = f"{gen_dir}/GBlock" + (f"_{i}" if i else "")
        sn(f"{blk}/conv0", (3, 3, cin, cout))
        sn(f"{blk}/conv1", (3, 3, cout, cout))
        sn(f"{blk}/conv_sc", (1, 1, cin, cout))
        for hyper, c in (("HyperBN", cin), ("HyperBN_1", cout)):
            for which in ("gamma", "beta"):
                sn(f"{blk}/{hyper}/{which}", (cond, c), bias=False)
            cr = hyper.replace("HyperBN", "CrossReplicaBN")
            d[f"{blk}/{cr}/accumulated_mean:0"] = rng.standard_normal(c, np.float32) * 0.01
            d[f"{blk}/{cr}/accumulated_var:0"] = 1 + rng.random(c, np.float32) * 0.1
    ca = arch["out_channels"][geo["attn_block"]]
    for name, cin, cout in (("theta", ca, ca // 8), ("phi", ca, ca // 8), ("g", ca, ca // 2),
                            ("o_conv", ca // 2, ca)):
        sn(f"{gen_dir}/attention/{name}", (1, 1, cin, cout), bias=False)
    add(f"{gen_dir}/attention/gamma", (), scale=0.5)
    sn(f"{gen_dir}/G_Z/G_linear", (z_chunk, 16 * 16 * ch))
    add("module/linear/w", (1000, 128), scale=1.0)
    d[f"{gen_dir}/ScaledCrossReplicaBN/gamma{suff}:0"] = \
        1 + rng.standard_normal((1, 1, 1, ch), np.float32) * np.float32(0.05)
    add(f"{gen_dir}/ScaledCrossReplicaBN/beta", (1, 1, 1, ch))
    d[f"{gen_dir}/ScaledCrossReplicaBNbn/accumulated_mean:0"] = \
        rng.standard_normal(ch, np.float32) * 0.01
    d[f"{gen_dir}/ScaledCrossReplicaBNbn/accumulated_var:0"] = 1 + rng.random(ch, np.float32) * 0.1
    sn(f"{gen_dir}/conv_2d", (3, 3, ch, 3))
    return d


def _tfhub(device, profile=False) -> dict:
    """A synthetic TFHub BigGAN-256 dump through ``convert_tfhub_dump`` and
    ``load_tfhub_generator``, folded and in bf16 behind ``make_sampler`` at
    batch 128 (img/s, peak memory, B1 a batch), against the same weights in
    f32 on the CPU at phase 6's bars; then ``cli/convert_tfhub.py``."""
    from ic_gan_tpu_torch.cli import convert_tfhub
    from ic_gan_tpu_torch.io import tfhub_import
    from ic_gan_tpu_torch.io.deploy import set_compute_dtype
    from ic_gan_tpu_torch.io.tfhub_import import convert_tfhub_dump, load_tfhub_generator
    from ic_gan_tpu_torch.io.torch_import import load_generator_state_dict

    t0 = time.perf_counter()
    dump = _tfhub_dump(TFHUB_RES, tfhub_import._CH, np.random.default_rng(193))
    path = os.path.join(APPS_DIR, f"biggan-{TFHUB_RES}.npz")
    np.savez(path, **dump)
    sd = convert_tfhub_dump(dump, TFHUB_RES)
    del dump
    make_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    g, cfg = load_tfhub_generator(path, TFHUB_RES, device=device)
    sync()
    load_s = time.perf_counter() - t0
    if not all(torch.equal(g.state_dict()[k].cpu(), torch.as_tensor(v)) for k, v in sd.items()):
        raise AssertionError("tfhub: the loaded G does not hold the converted state dict")
    unfolded = {k: v.detach().clone() for k, v in g.state_dict().items()}
    fold_spectral_norm(g)
    weights = {k: v.detach().clone() for k, v in g.state_dict().items()}
    cast_params(set_compute_dtype(g, torch.bfloat16))
    sampler = make_sampler(g, batch_size=SAMPLER_BATCH, device=device)
    gen = torch.Generator(device=device).manual_seed(194)
    z = torch.randn((SAMPLER_BATCH, cfg.effective_dim_z), generator=gen, device=device)
    y = torch.randint(0, cfg.n_classes, (SAMPLER_BATCH,), generator=gen, device=device)
    imgs, launches = _launches(sampler, z, y)
    if launches["B1"] != 1 or sum(launches.values()) != 1 or not torch.isfinite(imgs).all():
        raise AssertionError(f"tfhub sampler: launches {launches} for one batch")
    reset_peak()
    times = []
    for _ in range(5):
        sync()
        t1 = time.perf_counter()
        sampler(z, y, device_output=True)
        sync()
        times.append(time.perf_counter() - t1)
    med = statistics.median(times)
    peak = peak_gib()
    if profile:
        phase_profile(f"one TFHub sampler batch of {SAMPLER_BATCH}",
                      lambda: sampler(z, y, device_output=True))
    attn = [m for m in g.modules() if isinstance(m, SelfAttention)]
    parity = generator_parity(g, weights, device)
    del sampler, g
    torch.cuda.empty_cache()
    pth, grid = os.path.join(APPS_DIR, "tfhub.pth"), os.path.join(APPS_DIR, "tfhub.png")
    reset_counts()
    t0 = time.perf_counter()
    cg, _ = convert_tfhub.main(["--set", f"dump={path}", f"resolution={TFHUB_RES}",
                                f"pth_out={pth}", f"sample_grid={grid}", "--device", str(device)])
    cli_s, cli_launches = time.perf_counter() - t0, counts()
    again = load_generator_state_dict(torch.load(pth, weights_only=True), cfg, device=device)[0]
    same = all(torch.equal(v, unfolded[k]) for k, v in again.state_dict().items()) and \
        all(torch.equal(v, unfolded[k]) for k, v in cg.state_dict().items())
    if not same or cli_launches["B1"] != 1 or not os.path.exists(grid):
        raise AssertionError(f"convert_tfhub: weights kept {same}, launches {cli_launches}")
    log(f"tfhub: a synthetic BigGAN-{TFHUB_RES} dump (ch {cfg.G_ch}, dim_z {cfg.dim_z}, "
        f"attention at {cfg.G_attn}^2, {sum(v.size for v in sd.values()) / 1e6:.2f} M values) "
        f"made and converted in {make_s:.2f} s; load_tfhub_generator from its .npz {load_s:.2f} s (σ "
        f"synthesized by power iteration on the host); {len(attn)} attention layer, B1 once "
        f"a batch")
    log_card(f"tfhub sampler batch {SAMPLER_BATCH} bf16: {SAMPLER_BATCH / med:.2f} img/s "
             f"({1e3 * med:.2f} ms a batch, median of 5: "
             + ", ".join(f"{1e3 * t:.2f}" for t in times) + f"); peak memory {peak:.2f} GiB; "
             f"B1 launches a batch {launches['B1']}")
    log(f"convert_tfhub CLI: pth_out and the bf16 sample grid in {cli_s:.2f} s; the .pth "
        f"reloads bit for bit; B1 launches {cli_launches['B1']}")
    return dict(img_per_s=SAMPLER_BATCH / med, peak_gib=peak, load_s=load_s, parity=parity,
                launches=launches["B1"] + cli_launches["B1"], cli_s=cli_s)


def _tf1_graph(seed) -> bytes:
    """A TF1 GraphDef over every op ``TFGraphExecutor`` handles, fed at
    ``ExpandDims`` (N, 256, 256, 3) in [0, 255]: the legacy resize to 299²,
    the (x − 128)/128 shift, 8 convolutions with batch norm, both concats and
    both pools down to a 2048-wide ``pool_3`` (N, 1, 1, 2048), and the
    official ``softmax/logits/MatMul`` → ``softmax`` head over 1008 classes.
    He-normal weights from ``seed``."""
    from ic_gan_tpu_torch.io.graphdef import encode_graphdef, encode_node

    rng = np.random.RandomState(seed)
    nodes = []

    def node(name, op, inputs, attrs=None):
        nodes.append(encode_node(name, op, inputs, attrs or {}))
        return name

    def const(name, a):
        return node(name, "Const", [], {"value": {"tensor": np.asarray(a)}})

    def conv(name, x, k, cin, cout, stride, pad, bn=True):
        w = const(f"{name}/w", (rng.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)))
                  .astype(np.float32))
        y = node(name, "Conv2D", [x, w], {"strides": {"list_i": [1, stride, stride, 1]},
                                          "padding": {"s": pad}})
        if not bn:
            return y
        m, v, b, g_ = (const(f"{name}/bn/{n}", a.astype(np.float32)) for n, a in (
            ("m", 0.1 * rng.randn(cout)), ("v", rng.uniform(0.5, 1.5, cout)),
            ("b", 0.1 * rng.randn(cout)), ("g", rng.uniform(0.5, 1.5, cout))))
        y = node(f"{name}/bn", "BatchNormWithGlobalNormalization", [y, m, v, b, g_],
                 {"variance_epsilon": {"f": 1e-3}, "scale_after_normalization": {"b": True}})
        return node(f"{name}/relu", "Relu", [y])

    def pool(name, op, x, k, s, pad):
        return node(name, op, [x], {"ksize": {"list_i": [1, k, k, 1]},
                                    "strides": {"list_i": [1, s, s, 1]}, "padding": {"s": pad}})

    x = node("ExpandDims", "Placeholder", [], {"dtype": {"type": 1}})
    x = node("Cast", "Cast", [node("Identity", "Identity", [x])], {"DstT": {"type": 1}})
    x = node("ResizeBilinear", "ResizeBilinear",
             [x, const("ResizeBilinear/size", np.asarray([299, 299], np.int32))],
             {"align_corners": {"b": False}})
    x = node("Sub", "Sub", [x, const("Sub/y", np.float32(128.0))])
    x = node("Mul", "Mul", [x, const("Mul/y", np.float32(1 / 128.0))])
    x = conv("conv", x, 3, 3, 32, 2, b"VALID")                       # 149²
    x = conv("conv_1", x, 3, 32, 64, 2, b"SAME")                    # 75²
    x = pool("pool", "MaxPool", x, 3, 2, b"VALID")                  # 37²
    a = conv("mixed/branch_1x1", x, 1, 64, 96, 1, b"SAME")
    b = conv("mixed/branch_3x3", x, 3, 64, 96, 1, b"SAME")
    x = node("mixed/join", "Concat", [const("mixed/axis", np.int32(3)), a, b])
    x = node("mixed/add", "Add", [pool("mixed/avg", "AvgPool", x, 3, 1, b"SAME"), x])
    x = conv("conv_2", x, 3, 192, 256, 2, b"SAME")                  # 19²
    x = pool("pool_1", "MaxPool", x, 3, 2, b"VALID")                # 9²
    a = conv("mixed_10/branch_a", x, 1, 256, 1024, 1, b"SAME", bn=False)
    b = conv("mixed_10/branch_b", x, 1, 256, 1024, 1, b"SAME", bn=False)
    x = node("mixed_10/join", "ConcatV2", [a, b, const("mixed_10/axis", np.int32(3))])
    x = node("mixed_10/relu", "Relu", [node("mixed_10/bias", "BiasAdd", [
        x, const("mixed_10/b", (0.1 * rng.randn(2048)).astype(np.float32))])])
    x = pool("pool_3", "AvgPool", x, 9, 1, b"VALID")                # (N, 1, 1, 2048)
    x = node("pool_3/squeeze", "Squeeze", [x], {"squeeze_dims": {"list_i": [1, 2]}})
    x = node("pool_3/expand", "ExpandDims", [x, const("pool_3/axis", np.int32(1))])
    x = node("pool_3/reshape", "Reshape", [x, const("pool_3/shape",
                                                      np.asarray([1, 2048], np.int32))])
    w = const("softmax/weights", (rng.randn(2048, 1008) / np.sqrt(2048)).astype(np.float32))
    x = node("softmax/logits/MatMul", "MatMul", [x, w])
    x = node("softmax/logits", "BiasAdd", [x, const("softmax/biases", np.zeros(1008, np.float32))])
    node("softmax", "Softmax", [x])
    return encode_graphdef(nodes)


def _official_tf1(device, bank) -> dict:
    """``OfficialTF1Evaluator`` and ``cli/official_eval.py`` over 1,024 of
    phase 5's images (and 1,024 more for ``fid_a``/``fid_b``), img/s; the
    card's executor against the CPU's at 1e-3."""
    from ic_gan_tpu_torch.cli import official_eval
    from ic_gan_tpu_torch.eval.tf_inception import (
        OfficialTF1Evaluator,
        TFGraphExecutor,
        evaluate_images,
    )
    from ic_gan_tpu_torch.io.graphdef import parse_graphdef

    pb = _tf1_graph(195)
    pb_path = os.path.join(APPS_DIR, "classify_image_graph_def.pb")
    with open(pb_path, "wb") as f:
        f.write(pb)
    g16, _ = build_generator(device)
    sampler = make_sampler(g16, batch_size=SAMPLER_BATCH, device=device)
    feats = np.load(bank)
    gen = torch.Generator(device=device).manual_seed(196)
    reset_counts()
    sets = []
    for i in range(2):
        z = torch.randn((TF1_IMAGES, g16.cfg.effective_dim_z), generator=gen, device=device)
        idx = np.random.RandomState(197 + i).randint(0, len(feats), TF1_IMAGES)
        imgs = sampler(z, None, feats[idx])
        path = os.path.join(APPS_DIR, f"samples_{i}.npz")
        np.savez(path, x=np.transpose(np.uint8(np.clip((imgs + 1) * 127.5, 0, 255)),
                                      (0, 3, 1, 2)))
        sets.append(path)
    sample_b1 = counts()["B1"]
    del sampler, g16
    torch.cuda.empty_cache()
    runs = []
    for i, path in enumerate(sets):
        sync()
        t0 = time.perf_counter()
        res = official_eval.main(["--set", f"samples={path}", f"pb_path={pb_path}",
                                  f"out_dir={APPS_DIR}", f"pool_npz=TF_pool_{i}.npz",
                                  f"batch_size={TF1_BATCH}", "--device", str(device)])
        sync()
        runs.append((res, time.perf_counter() - t0))
    fid = official_eval.main(["--set", f"fid_a={os.path.join(APPS_DIR, 'TF_pool_0.npz')}",
                              f"fid_b={os.path.join(APPS_DIR, 'TF_pool_1.npz')}",
                              "--device", str(device)])["FID"]
    ev = OfficialTF1Evaluator(pb_path, device=device)
    imgs = official_eval._load_samples(sets[0])
    ev(np.uint8(255 * (imgs[:TF1_BATCH] + 1) / 2.0).astype(np.float32))  # warm-up
    sync()
    t0 = time.perf_counter()
    direct = evaluate_images(ev, imgs, batch=TF1_BATCH)
    sync()
    eval_s = time.perf_counter() - t0
    for k in ("IS_mean", "IS_std", "mu", "sigma"):
        if not np.allclose(direct[k], runs[0][0][k], rtol=1e-6, atol=1e-7):
            raise AssertionError(f"official_eval: {k} differs from evaluate_images'")
    # The fid_a/fid_b path is frechet_distance on the saved moments; float64
    # on the host beside it (both covariances have rank < 2048 here).
    (mu_a, s_a), (mu_b, s_b) = ((f["mu"], f["sigma"]) for f in (
        np.load(os.path.join(APPS_DIR, f"TF_pool_{i}.npz")) for i in (0, 1)))
    fid_direct = frechet_distance(mu_a, s_a, mu_b, s_b, device=device)
    fid64 = fid_f64(mu_a, s_a, mu_b, s_b)
    if not (np.isfinite(fid) and fid == fid_direct
            and runs[0][0]["pool"].shape == (TF1_IMAGES, 2048)):
        raise AssertionError(f"official_eval: FID {fid}, frechet_distance {fid_direct}")
    x255 = torch.from_numpy(np.uint8(255 * (imgs[:TF1_CHECK_IMAGES] + 1) / 2.0).astype(np.float32))
    nodes = parse_graphdef(pb)
    worst = {}
    with full_f32():                       # OfficialTF1Evaluator's precision
        outs = {dev: TFGraphExecutor(nodes, "ExpandDims", ["pool_3", "softmax"], device=dev)(
            x255.to(dev)) for dev in (device, torch.device("cpu"))}
    for name, got, ref in zip(("pool_3", "softmax"), outs[device], outs[torch.device("cpu")]):
        worst[name] = (got.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    if not all(w <= TF1_REL for w in worst.values()):
        raise AssertionError(f"TF1 executor card against CPU: {worst}")
    log_card(f"official TF1 (a {len(nodes)}-node GraphDef over every op TFGraphExecutor "
             f"handles, 299^2, 2048-wide pool_3, 1008-way softmax; weights from a seed): "
             f"evaluate_images over {TF1_IMAGES} of phase 5's images at batch {TF1_BATCH} "
             f"{TF1_IMAGES / eval_s:.1f} img/s ({eval_s:.3f} s); cli/official_eval.py "
             + ", ".join(f"{TF1_IMAGES / s:.1f}" for _, s in runs) + " img/s end to end "
             f"(the npz read included); IS {runs[0][0]['IS_mean']:.4f} ± "
             f"{runs[0][0]['IS_std']:.4f}, equal to evaluate_images'; fid_a/fid_b FID "
             f"{fid:.4f}, equal to frechet_distance's, against {fid64:.4f} in float64 on the "
             f"host (traces {np.trace(s_a):.1f}, {np.trace(s_b):.1f}; covariances of rank < "
             f"2048); card against CPU executor on {TF1_CHECK_IMAGES} images: "
             + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
             + f" of max(1, |CPU|) (bar {TF1_REL:g}); B1 {sample_b1} for the samples")
    return dict(img_per_s=TF1_IMAGES / eval_s, cli_img_per_s=[TF1_IMAGES / s for _, s in runs],
                fid=fid, fid_f64=fid64, card_vs_cpu=worst, launches=sample_b1)


def phase_remaining_clis(device, sg2_logs, biggan_logs, profile=False) -> dict:
    """Phase 19: the sheets (cli/visualize.py), the projector, the CLIP-guided
    search, the TFHub importer and its CLI, the official TF1 Inception and
    its CLI, and plot_logs' series of phases 12 and 13."""
    shutil.rmtree(APPS_DIR, ignore_errors=True)
    os.makedirs(APPS_DIR)
    t0 = time.perf_counter()
    for cut in PHASE19_CUTS:
        log(f"phase 19 cut: {cut}")
    out, part_s = {}, {}

    def part(name, fn, *args):
        sync()
        t1 = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.empty_cache()
        part_s[name] = time.perf_counter() - t1

    try:
        bank = _stored_bank(STORED_INSTANCES, 190)
        part("visualize", _biggan_sheets, device, bank)
        pkl = _sg2_snapshot(device, APPS_DIR)
        part("sg2_sheets", _sg2_sheets, device, pkl, bank)
        part("projector", _projector, device, pkl, bank, profile)
        part("clip_guided", lambda: _clip_guided(device, build_generator(device)[1], bank,
                                                 profile))
        part("tfhub", _tfhub, device, profile)
        part("official_tf1", _official_tf1, device, bank)
    finally:
        shutil.rmtree(APPS_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    for name, series in (("phase 12 (StyleGAN2)", sg2_logs), ("phase 13 (BigGAN)", biggan_logs)):
        if not series:
            raise AssertionError(f"plot_logs read no series of {name}'s logs")
        log(f"plot_logs series of {name}: " + "; ".join(
            f"{k} " + ", ".join(f"{float(x):.4g}" for x in v) for k, v in sorted(series.items())))
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 19 took {out['phase_s']:.1f} s, its checks included: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()))
    return out


# -- phase 20: the batch loader and data parallelism ------------------------------------

LOADER_IMAGES, LOADER_BATCH, LOADER_RES = 1024, 256, 256
# The world-1 NCCL steps: phase 7's BigGAN in f32 (phase 8's bars hold it
# against the plain step) and phase 10's StyleGAN2-ADA; timed steps of each.
DP_TIMED_STEPS = 3
# Two ranks on the one card over gloo: dryrun_multichip's toy geometry in
# f32 (attention at 16² in the BigGAN leg's D, so that B1 and B2 run; in G
# as well, the toy's f32 gradients move by ~1 % of their size between one
# rank and two on the CPU, where f32 against f64 differs by more than their
# size: that G is ill-conditioned in f32.  The 'bgc' ADA pipe on the fast
# geometry in the StyleGAN2 leg, so that B3 runs).
DP_WORLD = 2
DP_BIGGAN = dict(resolution=32, n_classes=10, G_ch=8, D_ch=8, dim_z=20, G_attn="0",
                 D_attn="16", shared_dim=16, shared_dim_feat=24, instance_sz=32)
DP_SG2 = dict(img_resolution=8, z_dim=8, c_dim=0, h_dim=12, w_dim=16, channel_base=512,
              channel_max=32, num_fp16_res=0, conv_clamp=None, num_mapping_layers=2,
              mbstd_group_size=2)
# f32 on the card, two ranks against one: raw gradients max|Δ| ≤ 1e-3 of the
# tensor's max|g| plus 1e-5 of the network's (phase 8's floor, for the
# biases before a batch norm, whose true gradient is 0), scalars 1e-4.  The
# sound runs read at most 2.4e-5 of the tensor's max; minibatch std taken
# per rank reads 8.2e-3 in the float64 CPU test.
DP_GRAD_REL, DP_GRAD_FLOOR, DP_SCALAR_REL = 1e-3, 1e-5, 1e-4
DP_DIR = os.path.join(str(_build.BUILD_DIR), "chip_smoke_dp")
DP_TIMEOUT_S = 300


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _loader_phase(device, loop_ips, moments_ips) -> dict:
    """(a) ``normalize_batch`` bit for bit against the host formulas, and
    its throughput against the f32 path it replaced (the formula on the
    host, float32 copied to the card), in turns."""
    rng = np.random.default_rng(95)
    u8 = rng.integers(0, 256, (LOADER_IMAGES, 3, LOADER_RES, LOADER_RES), dtype=np.uint8)
    b = u8[:LOADER_BATCH]
    mask = rng.integers(0, 2, LOADER_BATCH).astype(np.uint8)
    scale = np.float32(2.0) / np.float32(255.0)
    for formula in data_loader.FORMULAS:
        for flip in (None, mask):
            x = b.copy()
            if flip is not None:
                x[flip == 1] = x[flip == 1][:, :, :, ::-1]
            x = x.astype(np.float32)
            want = x * scale + np.float32(-1.0) if formula == "loader" \
                else (x / 255.0 - 0.5) * 2.0
            got = data_loader.normalize_batch(b, flip, True, device=device, formula=formula)
            if got.device.type != device.type or not np.array_equal(_bits(got.cpu().numpy()),
                                                               _bits(want)):
                raise AssertionError(f"loader {formula} flip {flip is not None}: not the host "
                                     "formula bit for bit")

    def f32_path():
        for lo in range(0, LOADER_IMAGES, LOADER_BATCH):
            torch.from_numpy(u8[lo:lo + LOADER_BATCH].astype(np.float32) * scale
                             + np.float32(-1.0)).to(device)
        sync()

    def u8_path():
        for lo in range(0, LOADER_IMAGES, LOADER_BATCH):
            data_loader.normalize_batch(u8[lo:lo + LOADER_BATCH], None, True, device=device)
        sync()

    paths = {"f32": f32_path, "loader": u8_path}
    times = {k: [] for k in paths}
    for name in ("f32", "loader", "f32", "loader", "loader", "f32"):
        t0 = time.perf_counter()
        paths[name]()
        times[name].append(time.perf_counter() - t0)
    ips = {k: LOADER_IMAGES / min(v[1:]) for k, v in times.items()}   # the first is a warm-up
    nbytes = dict(f32=4 * u8.size, loader=u8.size)
    log_card(f"phase 20 (a) loader: both formulas, with and without the flip, equal to the host "
             f"formulas bit for bit on the card; {LOADER_IMAGES} uint8 images at "
             f"{LOADER_RES}^2 in batches of {LOADER_BATCH}: loader {ips['loader']:.1f} img/s "
             f"copying {nbytes['loader'] / 2 ** 20:.0f} MiB, the f32 path {ips['f32']:.1f} img/s "
             f"copying {nbytes['f32'] / 2 ** 20:.0f} MiB (best of 2 after a warm-up, in turns); "
             f"through the loader: phase 13's loop "
             + ", ".join(f"{e:.1f}" for e in loop_ips)
             + f" img/s an epoch, phase 17's moments {moments_ips:.1f} img/s")
    return dict(img_per_s=ips, bytes=nbytes, loop_img_per_s=loop_ips,
                moments_img_per_s=moments_ips)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grad_gap(got: dict, ref: dict, rel: float, floor: float, what: str,
              abs_floor: float = 0.0) -> float:
    """Worst |Δ| of the gradients against ``rel``·max|ref| + ``floor``·(the
    network's largest) + ``abs_floor``, relative to the tensor's max (or the
    floor's share); raises past the bar."""
    worst = 0.0
    for which in ("g_grads", "d_grads"):
        top = max(v.abs().max().item() for v in ref[which].values())
        for k, r in ref[which].items():
            if k.endswith("noise_strength"):
                continue
            err = (got[which][k].to(r.device) - r).abs().max().item()
            rmax = r.abs().max().item()
            if not err <= rel * rmax + floor * top + abs_floor:
                raise AssertionError(f"{what} {which} {k}: max|Δ| {err:.3e} (max|ref| {rmax:.3e})")
            worst = max(worst, err / max(rmax, floor * top / rel, 1e-30))
    return worst


def _scalar_gap(got: dict, ref: dict, rel: float, what: str) -> float:
    worst = 0.0
    for k, v in ref.items():
        if k in ("g_grads", "d_grads"):
            continue
        a, b = float(got[k]), float(v)
        gap = abs(a - b) / max(abs(b), 1e-6)
        if not (gap <= rel or a == b):
            raise AssertionError(f"{what} {k}: {a} against {b}")
        worst = max(worst, gap)
    return worst


def _timed_steps(step, state, batch, gen) -> float:
    times = []
    for _ in range(DP_TIMED_STEPS):
        sync()
        t0 = time.perf_counter()
        step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _world1_biggan(device, mesh) -> dict:
    """Phase 7's BigGAN in f32, the data-parallel step at world 1 against
    the plain step from the same state and draws."""
    cfg, g0, d0 = build_gan(TRAIN_MODEL, torch.float32, device, seed=91)
    tcfg = TrainConfig(ema_start=0, adam_eps=1e-3)
    gen = torch.Generator(device=device).manual_seed(92)
    res, mb = cfg.resolution, TRAIN_MB
    batch = dict(x=torch.rand((1, mb, 3, res, res), generator=gen, device=device) * 2 - 1,
                 feats=torch.randn((1, mb, cfg.instance_sz), generator=gen, device=device),
                 gen_feats=torch.randn((2, mb, cfg.instance_sz), generator=gen, device=device))
    out = {}
    for name, m in (("plain", None), ("dp", mesh)):
        g, d = copy.deepcopy(g0), copy.deepcopy(d0)
        state = GANTrainState.create(g, d, tcfg.g_optimizer(), tcfg.d_optimizer())
        reset_counts()
        _, metrics = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True, mesh=m)(
            state, batch, torch.Generator(device=device).manual_seed(93))
        sync()
        launches = counts()
        if launches != dict(B1=4, B2=3, B3=0, B4=0, B4bwd=0):
            raise AssertionError(f"world-1 BigGAN {name} step launches {launches}: expected "
                                 "B1 4 and B2 3")
        ms = _timed_steps(make_train_step(tcfg, cfg.effective_dim_z, mesh=m), state, batch,
                          torch.Generator(device=device).manual_seed(94))
        out[name] = dict(metrics=metrics, launches=launches, ms=ms)
        del g, d, state
    del g0, d0
    worst = dict(
        grads=_grad_gap(out["dp"]["metrics"], out["plain"]["metrics"], PARITY_GRAD_REL,
                        PARITY_GRAD_FLOOR, "world-1 BigGAN"),
        losses=_scalar_gap(out["dp"]["metrics"], out["plain"]["metrics"], 1e-4,
                           "world-1 BigGAN"))
    return dict(worst=worst, launches=out["dp"]["launches"],
                ms={k: v["ms"] for k, v in out.items()})


def _world1_sg2(device, mesh) -> dict:
    """Phase 10's StyleGAN2-ADA, a main and a reg step at world 1 against
    the plain ones from the same state and draws, and the plain step once
    more against itself (what the card's run-to-run differences give).  In
    f32 (phase 11's bars are f32's) gated and timed; at phase 10's bf16
    resolutions logged only, the two readings side by side."""
    tcfg = SG2TrainConfig()
    pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")
    worst, ms, launches = {}, {}, dict(B1=0, B2=0, B3=0, B4=0, B4bwd=0)
    for kind, model in (("f32", dict(SG2_MODEL, num_fp16_res=0)), ("bf16", SG2_MODEL)):
        cfg, g0, d0 = build_sg2(model, device, seed=96)
        gen = torch.Generator(device=device).manual_seed(97)
        mb, res = SG2_MB, cfg.img_resolution
        batch = dict(x=torch.rand((mb, 3, res, res), generator=gen, device=device) * 2 - 1,
                     h=torch.randn((mb, cfg.h_dim), generator=gen, device=device),
                     gen_h=torch.randn((mb, cfg.h_dim), generator=gen, device=device))
        expected = sg2_expected_launches(g0, d0)
        for reg in (False, True):
            tag = "reg" if reg else "main"
            out = {}
            for name, m in (("plain", None), ("dp", mesh), ("plain again", None)):
                g, d = copy.deepcopy(g0), copy.deepcopy(d0)
                state = SG2TrainState.create(g, d, tcfg)
                state.ada_p = torch.full((), SG2_P, device=device)
                reset_counts()
                _, metrics = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg,
                                                 augment_fn=pipe, debug_grads=True, mesh=m)(
                    state, batch, torch.Generator(device=device).manual_seed(98))
                sync()
                c = counts()
                want = expected[tag]
                if (c["B4"], c["B4bwd"], c["B3"]) != (want["B4"], want["B4bwd"],
                                                       sum(want["B3"].values())):
                    raise AssertionError(f"world-1 sg2 {kind} {tag} {name} launches {c}, "
                                         f"expected {want}")
                if m is not None:
                    launches = {k: launches[k] + v for k, v in c.items()}
                if kind == "f32" and name != "plain again":
                    ms[f"{tag} {name}"] = _timed_steps(
                        make_sg2_train_step(tcfg, cfg.z_dim, do_pl=reg, do_r1=reg,
                                            augment_fn=pipe, mesh=m),
                        state, batch, torch.Generator(device=device).manual_seed(99))
                out[name] = metrics
                del g, d, state
            gated = kind == "f32"
            worst[f"{kind} {tag} grads"] = _grad_gap(
                out["dp"], out["plain"], 1e-2 if gated else 1.0, 0.0,
                f"world-1 sg2 {kind} {tag}", 1e-12 if gated else 1.0)
            if gated:
                worst[f"{kind} {tag} losses"] = _scalar_gap(out["dp"], out["plain"], 1e-4,
                                                            f"world-1 sg2 {kind} {tag}")
            worst[f"{kind} {tag} grads, plain twice"] = _grad_gap(
                out["plain again"], out["plain"], 1.0, 0.0, "plain twice", 1.0)
        del g0, d0
        torch.cuda.empty_cache()
    return dict(worst=worst, launches=launches,
                ms={t: {n: ms[f"{t} {n}"] for n in ("plain", "dp")} for t in ("main", "reg")})


def _dp_toy_leg(leg: str, mesh, with_ref: bool) -> dict:
    """One leg of (c) in a rank: the toy step over the mesh (its kernel
    launches counted) and, with ``with_ref``, on one rank over the global
    batch; gradients and metrics on the host."""
    dev = mesh.device
    host = lambda m: {k: ({n: t.detach().cpu() for n, t in v.items()} if isinstance(v, dict)  # noqa: E731
                          else float(v)) for k, v in m.items()}
    out = {}
    if leg == "biggan":
        cfg = BigGANConfig(**DP_BIGGAN)
        tcfg = TrainConfig(num_D_steps=1, num_D_accumulations=2, num_G_accumulations=2,
                           ema_start=0, adam_eps=1e-3, DiffAugment=DIFF_AUGMENT, G_ortho=1e-4,
                           D_ortho=1e-4)
        _, g0, d0 = build_gan(DP_BIGGAN, torch.float32, dev, seed=101)
        gen = torch.Generator().manual_seed(102)
        mb = 2 * mesh.world
        batch = dict(x=torch.randn((2, mb, 3, 32, 32), generator=gen) * 0.5,
                     feats=torch.randn((2, mb, cfg.instance_sz), generator=gen),
                     gen_feats=torch.randn((4, mb, cfg.instance_sz), generator=gen))
        batch = {k: v.to(dev) for k, v in batch.items()}
        for name, m in (("ref", None), ("dp", mesh)):
            if name == "ref" and not with_ref:
                continue
            state = GANTrainState.create(copy.deepcopy(g0), copy.deepcopy(d0),
                                         tcfg.g_optimizer(), tcfg.d_optimizer())
            reset_counts()
            _, metrics = make_train_step(tcfg, cfg.effective_dim_z, debug_grads=True, mesh=m)(
                state, batch if m is None else shard_batch(m, batch, axis=1),
                torch.Generator(device=dev).manual_seed(103))
            sync()
            out[name] = dict(metrics=host(metrics), launches=counts())
    else:
        cfg = sg2.StyleGAN2Config(**DP_SG2)
        _, g0, d0 = build_sg2(DP_SG2, dev, seed=104)
        tcfg = SG2TrainConfig()
        pipe = AugmentPipe.from_spec("bgc", geom_impl="fast")
        gen = torch.Generator().manual_seed(105)
        n = 2 * mesh.world
        batch = dict(x=torch.randn((n, 3, 8, 8), generator=gen) * 0.5,
                     h=torch.randn((n, cfg.h_dim), generator=gen),
                     gen_h=torch.randn((n, cfg.h_dim), generator=gen))
        batch = {k: v.to(dev) for k, v in batch.items()}
        for name, m in (("ref", None), ("dp", mesh)):
            if name == "ref" and not with_ref:
                continue
            state = SG2TrainState.create(copy.deepcopy(g0), copy.deepcopy(d0), tcfg)
            state.ada_p = torch.full((), SG2_P, device=dev)
            reset_counts()
            state, metrics = make_sg2_train_step(tcfg, cfg.z_dim, do_pl=True, do_r1=True,
                                                 augment_fn=pipe, debug_grads=True, mesh=m)(
                state, batch if m is None else shard_batch(m, batch),
                torch.Generator(device=dev).manual_seed(106))
            sync()
            metrics = dict(metrics, pl_mean=state.pl_mean, ada_sign_sum=state.ada_sign_sum)
            out[name] = dict(metrics=host(metrics), launches=counts())
    return out


def dp_worker(rank: int, world: int, init_method: str, out_dir: str, device: str) -> None:
    """One rank of phase 20 (c): both toy legs over a gloo group on
    ``device``."""
    from ic_gan_tpu_torch.parallel.mesh import distributed_init, make_mesh
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    distributed_init(num_processes=world, process_id=rank, init_method=init_method,
                     backend="gloo", device=device, timeout_s=DP_TIMEOUT_S)
    mesh = make_mesh(device=device)
    res = {leg: _dp_toy_leg(leg, mesh, with_ref=rank == 0) for leg in ("biggan", "sg2")}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _two_ranks(device) -> dict:
    """Phase 20 (c): ``DP_WORLD`` processes on ``device`` over gloo, the toy
    legs against one rank on the global batch."""
    world = DP_WORLD
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    torch.cuda.empty_cache()
    init = f"file://{os.path.join(DP_DIR, 'rendezvous')}"
    logs = [open(os.path.join(DP_DIR, f"log{r}.txt"), "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                               str(r), str(world), init, DP_DIR, str(device)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=DP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        tails = "\n".join(open(os.path.join(DP_DIR, f"log{r}.txt")).read()[-4000:]
                          for r in range(world))
        raise AssertionError(f"data-parallel workers exited {codes}:\n{tails}")
    ranks = [torch.load(os.path.join(DP_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    worst, launches = {}, dict(B1=0, B2=0, B3=0, B4=0, B4bwd=0)
    for leg in ("biggan", "sg2"):
        ref = ranks[0][leg]["ref"]["metrics"]
        for r, res in enumerate(ranks):
            got = res[leg]["dp"]["metrics"]
            worst[f"{leg} grads"] = max(worst.get(f"{leg} grads", 0.0), _grad_gap(
                got, ref, DP_GRAD_REL, DP_GRAD_FLOOR, f"{world} ranks {leg} rank {r}"))
            worst[f"{leg} scalars"] = max(worst.get(f"{leg} scalars", 0.0), _scalar_gap(
                got, ref, DP_SCALAR_REL, f"{world} ranks {leg} rank {r}"))
            for which in ("g_grads", "d_grads"):
                if any(not torch.equal(v, ranks[0][leg]["dp"]["metrics"][which][k])
                       for k, v in got[which].items()):
                    raise AssertionError(f"{world} ranks {leg}: rank {r}'s {which} differ "
                                         "from rank 0's")
            launches = {k: launches[k] + v for k, v in res[leg]["dp"]["launches"].items()}
        need = ("B1", "B2") if leg == "biggan" else ("B3", "B4", "B4bwd")
        if any(ranks[r][leg]["dp"]["launches"][k] == 0 for r in range(world) for k in need):
            raise AssertionError(f"{world} ranks {leg}: a rank launched none of {need}")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    return dict(worst=worst, launches=launches, wall_s=wall)


def phase_data_parallel(device, loop_ips, moments_ips) -> dict:
    """Phase 20: (a) the loader, (b) NCCL at world size 1 at full width,
    (c) two ranks on the one card over gloo at toy size."""
    from ic_gan_tpu_torch.parallel.mesh import distributed_init, make_mesh
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = dict(loader=_loader_phase(device, loop_ips, moments_ips))
    torch.cuda.empty_cache()
    distributed_init(coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1,
                     process_id=0, device=device)     # NCCL on the card
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the two steps' convs as one another's
    try:
        mesh = make_mesh(device=device)
        out["biggan"] = _world1_biggan(device, mesh)
        torch.cuda.empty_cache()
        out["sg2"] = _world1_sg2(device, mesh)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    bg, sg = out["biggan"], out["sg2"]
    log_card(f"phase 20 (b) NCCL at world size 1: BigGAN {TRAIN_MODEL['resolution']}^2 ch"
             f"{TRAIN_MODEL['G_ch']} f32 at microbatch {TRAIN_MB}, data-parallel against plain "
             f"from one state and draws: worst relative |Δ| grads {bg['worst']['grads']:.3e}, "
             f"losses {bg['worst']['losses']:.3e} (phase 8's bars); B1 {bg['launches']['B1']} "
             f"and B2 {bg['launches']['B2']} a step; ms/step plain {bg['ms']['plain']:.2f}, "
             f"data-parallel {bg['ms']['dp']:.2f} (median of {DP_TIMED_STEPS})")
    log_card(f"phase 20 (b) NCCL at world size 1: StyleGAN2-ADA {SG2_MODEL['img_resolution']}^2 "
             f"at microbatch {SG2_MB}, 'bgc' fast at p {SG2_P}: worst relative |Δ| "
             + ", ".join(f"{k} {v:.3e}" for k, v in sg["worst"].items())
             + f" (phase 11's bars on f32's data-parallel step; bf16 and plain twice logged "
             f"only); launches B3 {sg['launches']['B3']}, B4 {sg['launches']['B4']}, B4 "
             f"backward {sg['launches']['B4bwd']} over the main and reg steps of both; f32 "
             "ms/step " + ", ".join(f"{t} plain {v['plain']:.2f} data-parallel "
                                    f"{v['dp']:.2f}" for t, v in sg["ms"].items()))
    out["two_ranks"] = tr = _two_ranks(device)
    log_card(f"phase 20 (c) two ranks on the card over gloo, f32, toy geometry, against one "
             f"rank on the global batch: worst relative |Δ| "
             + ", ".join(f"{k} {v:.3e}" for k, v in tr["worst"].items())
             + f" (bars: grads {DP_GRAD_REL:g} of the tensor's max + {DP_GRAD_FLOOR:g} of the "
             f"network's, scalars {DP_SCALAR_REL:g}); both ranks' gradients equal; launches "
             f"over both ranks {tr['launches']}; {tr['wall_s']:.1f} s for the two processes")
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 20 took {out['phase_s']:.1f} s")
    return out


def main(argv) -> int:
    global CARD
    if argv[:1] == ["--dp-worker"]:     # one rank of phase 20 (c)
        dp_worker(int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5])
        return 0
    card = CARD = phase_env()
    device = torch.device("cuda", 0)
    dv256 = phase_build()
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
    phase_train_parity(device, cc=True)
    torch.cuda.empty_cache()
    sg2_run = phase_sg2_train(device, "--profile" in argv)
    torch.cuda.empty_cache()
    phase_sg2_train_parity(device)
    torch.cuda.empty_cache()
    loop = phase_sg2_loop(device)
    torch.cuda.empty_cache()
    bg = phase_biggan_loop(device)
    torch.cuda.empty_cache()
    ev = phase_eval(device, "--profile" in argv)
    shutil.rmtree(EVAL_DATA_DIR, ignore_errors=True)
    eval_b1 = sum(r["launches"]["B1"] for r in ev["runs"].values())
    deep_k = phase_deep_kernels()
    deep = phase_deep_sampler(device, "--profile" in argv)
    deep_train = phase_deep_train(device, "--profile" in argv)
    phase_train_parity(device, deep=True)
    deep_loop = phase_deep_loop(device)
    inference = phase_inference(device, deep)
    deep_launches, deep_per_batch = deep["launches"], deep["launches_per_batch"]
    deep_unfolded = deep["unfolded"]
    del deep
    torch.cuda.empty_cache()
    prep = phase_prepare_and_eval_clis(device)
    int8 = phase_int8_and_export(device, main_run["img_per_s"], deep_unfolded,
                                 "--profile" in argv)
    del deep_unfolded
    apps = phase_remaining_clis(device, loop["logs"], bg["logs"], "--profile" in argv)
    app_b1 = dict(visualize=apps["visualize"]["launches"],
                  clip_guided=apps["clip_guided"]["launches"]["B1"],
                  tfhub=apps["tfhub"]["launches"], official_tf1=apps["official_tf1"]["launches"])
    app_b4 = dict(visualize=apps["sg2_sheets"]["launches"],
                  projector=apps["projector"]["launches"]["B4"])
    dp = phase_data_parallel(device, [e["img_per_s"] for e in bg["epochs"]],
                             prep["moments_img_per_s"])
    dp_launches = lambda k: dict(  # noqa: E731
        dp_world1=dp["biggan"]["launches"][k] + dp["sg2"]["launches"][k],
        dp_two_ranks=dp["two_ranks"]["launches"][k])
    q_b1 = dict(int8_sampler=sum(int8[k]["launches"] for k in ("biggan", "deep")),
                exported_sampler=sum(e["launches"] for k in ("biggan", "deep")
                                     for e in int8[k]["exports"]))
    q_b4 = dict(int8_sampler=sum(int8["stylegan2"][k]["launches"]
                                 for k in ("int8", "int8 dynamic")),
                exported_sampler=int8["stylegan2"]["export"]["launches"])
    b2 = bwd_timings["G"]
    by_path = lambda sampler, train_, sg2_train, sg2_loop_=0, biggan_loop_=0, eval_=0, \
        deep_sampler=0, deep_train_=0, deep_loop_=0, inference_=0, test_cli=0, \
        calc_metrics_cli=0, int8_sampler=0, exported_sampler=0, visualize=0, projector=0, \
        clip_guided=0, tfhub=0, official_tf1=0, dp_world1=0, dp_two_ranks=0: dict(  # noqa: E731
            sampler=sampler, train=train_, sg2_train=sg2_train, sg2_loop=sg2_loop_,
            biggan_loop=biggan_loop_, eval=eval_, deep_sampler=deep_sampler,
            deep_train=deep_train_, deep_loop=deep_loop_, inference=inference_,
            test_cli=test_cli, calc_metrics_cli=calc_metrics_cli, int8_sampler=int8_sampler,
            exported_sampler=exported_sampler, visualize=visualize, projector=projector,
            clip_guided=clip_guided, tfhub=tfhub, official_tf1=official_tf1,
            dp_world1=dp_world1, dp_two_ranks=dp_two_ranks)
    deep_b1 = dict(deep_sampler=deep_launches, deep_train_=deep_train["launches"]["B1"],
                   deep_loop_=deep_loop["launches"]["B1"], inference_=inference["launches"],
                   test_cli=prep["test_launches"])
    deep_b2 = dict(deep_train_=deep_train["launches"]["B2"],
                   deep_loop_=deep_loop["launches"]["B2"])
    deep_shapes = lambda which: dict(  # noqa: E731
        shapes={k: list(v) for k, v in (("sampler", DEEP_SAMPLER_ATTN), ("G", DEEP_G_ATTN),
                                        ("D", DEEP_D_ATTN)) if k in deep_k[which]},
        timings=deep_k[which], max_abs_err=deep_k[f"{which}_err"],
        launches_per_train_step=deep_train["per_step"]["B1" if which == "fwd" else "B2"],
        launches_per_loop_step=deep_loop["per_step"]["B1" if which == "fwd" else "B2"],
        train_microbatch=deep_train["mb"],
        registers_and_spill_bytes={k: list(v) for k, v in dv256.items()
                                   if ("fwd" in k) == (which == "fwd")})
    per_loop_step = lambda k: {v: g[k] for v, (g, _) in loop["by_variant"].items()}  # noqa: E731
    b3, b3a = sg2_timings["B3"], sg2_timings["B3_adjoint"]
    b4, b4b = sg2_timings["B4"], sg2_timings["B4bwd"]
    b1 = timings["sampler"]
    kernels = [dict(
        name="sagan_attention_fwd", route="cuda",
        source="ic_gan_tpu_torch/csrc/sagan_attention_fwd.cu",
        replaces="ic_gan_tpu/ops/pallas/attention.py:56",
        launches=main_run["launches"] + train["fwd"] + bg["launches"]["B1"] + eval_b1
        + sum(deep_b1.values()) + sum(q_b1.values()) + sum(app_b1.values())
        + sum(dp_launches("B1").values()),
        launches_by_path=by_path(main_run["launches"], train["fwd"], 0, 0,
                                 bg["launches"]["B1"], eval_b1, **deep_b1, **q_b1, **app_b1,
                                 **dp_launches("B1")),
        launches_per_biggan_loop_step=bg["per_step"]["B1"],
        launches_per_eval_pass={m: r["launches"]["B1"] for m, r in ev["runs"].items()},
        max_abs_err=max_err["fwd"],
        ms=b1["kernel_ms"], plain_ms=b1["plain_ms"],
        bound_ms=b1["bound_ms"], bound_by=b1["bound_by"],
        library_ms=b1["library_ms"], tflops=b1["tflops"], of_bound=b1["of_bound"],
        tensor_core_instructions={k: v for k, v in tensor_cores.items() if "fwd" in k},
        train_shapes=dict(G=timings["G"], D=timings["D"]),
        deep_shapes=dict(deep_shapes("fwd"), launches_per_sampler_batch=deep_per_batch),
        inference_launches=dict(generate_images=inference["generate_launches"],
                                pth_sampler=inference["pth_launches"],
                                demo=inference["demo_launches"],
                                conditioned_sampler=inference["conditioned_launches"]),
        prepare_and_eval_clis={k: v for k, v in prep.items() if not k.endswith("launches")},
        int8_and_export={k: v for k, v in int8.items() if k != "stylegan2"},
        tfhub_shape=dict(shape=list(TFHUB_ATTN), **timings["tfhub sampler"],
                         plain="in chunks of %d samples" % PLAIN_CHUNK,
                         launches_per_sampler_batch=1,
                         sampler_img_per_s=apps["tfhub"]["img_per_s"]),
        search_shape_f32=dict(shape=list(SEARCH_ATTN), **timings["search f32"],
                              launches_per_iteration=apps["clip_guided"]["searches"]),
    ), dict(
        name="sagan_attention_bwd", route="cuda",
        source="ic_gan_tpu_torch/csrc/sagan_attention_bwd.cu",
        replaces="ic_gan_tpu/ops/pallas/attention.py:136",
        launches=train["bwd"] + bg["launches"]["B2"] + sum(deep_b2.values())
        + apps["clip_guided"]["launches"]["B2"] + sum(dp_launches("B2").values()),
        launches_by_path=by_path(0, train["bwd"], 0, 0, bg["launches"]["B2"], **deep_b2,
                                 clip_guided=apps["clip_guided"]["launches"]["B2"],
                                 **dp_launches("B2")),
        launches_per_biggan_loop_step=bg["per_step"]["B2"],
        max_abs_err=max_err["bwd"],
        ms=b2["kernel_ms"], plain_ms=b2["plain_ms"],
        bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
        library_ms=b2["library_ms"], tflops=b2["tflops"], of_bound=b2["of_bound"],
        tensor_core_instructions={k: v for k, v in tensor_cores.items() if "bwd" in k},
        train_shapes={k: v for k, v in bwd_timings.items() if k in ("G", "D")},
        search_shape_f32=dict(shape=list(SEARCH_ATTN), **bwd_timings["search f32"]),
        deep_shapes=deep_shapes("bwd"),
    ), dict(
        name="row_shift", route="cuda", source="ic_gan_tpu_torch/csrc/row_shift.cu",
        replaces="ic_gan_tpu/ops/pallas/row_shift.py:104",
        launches=sg2_run["launches"]["B3"] + loop["launches"]["B3"]
        + sum(dp_launches("B3").values()),
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B3"], loop["launches"]["B3"],
                                 **dp_launches("B3")),
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
        launches=sg2_run["launches"]["B4"] + loop["launches"]["B4"] + prep["calc_launches"]
        + sum(q_b4.values()) + sum(app_b4.values()) + sum(dp_launches("B4").values()),
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B4"], loop["launches"]["B4"],
                                 calc_metrics_cli=prep["calc_launches"], **q_b4, **app_b4,
                                 **dp_launches("B4")),
        launches_per_projector_step=apps["projector"]["per_step"]["B4"],
        int8_and_export=int8["stylegan2"],
        launches_per_step={k: v["B4"] // SG2_STEPS for k, v in sg2_run["per_phase"].items()},
        launches_per_loop_step=per_loop_step("B4"),
        max_abs_err=sg2_err["B4"], ms=b4["kernel_ms"], plain_ms=b4["plain_ms"],
        bound_ms=b4["bound_ms"], bound_by=b4["bound_by"], library_ms=None,
        of_bound=b4["of_bound"],
    ), dict(
        name="bias_act_bwd", route="cuda", source="ic_gan_tpu_torch/csrc/bias_act.cu",
        replaces="ic_gan_tpu/ops/pallas/bias_act.py:92 (the custom_jvp tangent of _forward)",
        launches=sg2_run["launches"]["B4bwd"] + loop["launches"]["B4bwd"]
        + apps["projector"]["launches"]["B4bwd"] + sum(dp_launches("B4bwd").values()),
        launches_by_path=by_path(0, 0, sg2_run["launches"]["B4bwd"], loop["launches"]["B4bwd"],
                                 projector=apps["projector"]["launches"]["B4bwd"],
                                 **dp_launches("B4bwd")),
        launches_per_projector_step=apps["projector"]["per_step"]["B4bwd"],
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
