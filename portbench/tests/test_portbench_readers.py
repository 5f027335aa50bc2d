"""The metric readers, the kernel classifier and the work counts, on a small
synthetic profiler trace and hand-worked values."""

import json

import pytest

import harness
from kernels import kernel_class
from peaks import PEAK_BYTES, PEAK_FLOPS, least_seconds
from tracing import WINDOW, Trace

# Names as they appear in the port's traces (PERF.md and chip_smoke.py's
# profiles), with the class each belongs to.
KERNEL_NAMES = [
    ("void sagan_attention_fwd_mma<__nv_bfloat16, 48, 192>(AttnArgs)", "attention forward B1"),
    ("void attn_bwd_kv_mma<__nv_bfloat16, 24, 96>(BwdArgs)", "attention backward B2"),
    ("void attn_bwd_q_mma<__nv_bfloat16, 24, 96>(BwdArgs)", "attention backward B2"),
    ("void row_shift_kernel<float>(float const*, float const*, float*, int, int, int)",
     "ADA row shift B3"),
    ("void bias_act_bwd_vec<__nv_bfloat16>(BwdParams)", "bias-activation B4 backward"),
    ("void bias_act_fwd_vec<float>(FwdParams)", "bias-activation B4"),
    ("sm80_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x32_stage4_warpsize2x2x1",
     "matmuls (cuBLAS and others)"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32_cluster1x1x1",
     "matmuls (cuBLAS and others)"),
    ("nvjet_tst_128x64_64x8_2x1_v_bz_coopA_NTN", "matmuls (cuBLAS and others)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "convs (cuDNN)"),
    ("sm80_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
     "convs (cuDNN)"),
    ("sm80_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convs (cuDNN)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(...)",
     "cuDNN NCHW<->NHWC transforms"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>(...)", "reductions"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>(...)",
     "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>(...)",
     "copies and concatenation"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>, FusedAdamMathFunctor>",
     "optimizer"),
    ("Memcpy HtoD (Pageable -> Device)", "host-device copies"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collectives (NCCL)"),
]


@pytest.mark.parametrize("name,label", KERNEL_NAMES)
def test_kernel_classes(name, label):
    assert kernel_class(name) == label


def _trace():
    # window 0..100 ns; device: two overlapping kernels, a copy, one outside
    dev = [("sagan_attention_fwd_mma", 10, 30), ("vectorized_elementwise_kernel", 20, 40),
           ("Memcpy HtoD (Pageable -> Device)", 60, 70), ("outside", 150, 160)]
    host = [(WINDOW, 0, 100), ("aten::conv2d", 35, 90), ("aten::copy_", 45, 55)]
    return Trace(device=dev, host=host, window=(0, 100), calls=2)


def test_trace_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.busy_intervals() == [[10, 40], [60, 70]]
    assert tr.busy_s == pytest.approx(40e-9) and tr.window_s == pytest.approx(100e-9)
    assert tr.idle_gaps() == [(0, 10), (40, 60), (70, 100)]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["attention forward B1", pytest.approx(20e-9)]
    assert [g[0] for g in b["idle_gaps"]] == ["aten::conv2d", "aten::conv2d", "host idle"]
    assert b["idle_gaps"][0][1] == pytest.approx(30e-9)


def test_readers_on_a_synthetic_trace():
    tr = _trace()
    tr.extra["attention"] = [("fwd", None, 2e6, 1e4)]
    obs = dict(kind="sample", chips=1, trace=tr, peak_bytes=3 * 2 ** 30,
               rate=dict(seconds=2.0, flops=989e12 * 0.5, peak=989e12),
               latencies=[float(i) for i in range(1, 101)], images=400, window_s=4.0)
    read = lambda m: harness.reader(m).read(obs)  # noqa: E731
    assert read("launches.sample") == 1.0          # two kernels per two calls; copies are not
    assert read("device_idle.sample") == pytest.approx(60.0)
    assert read("mfu.sample") == pytest.approx(25.0)
    assert read("peak_gib.sample") == pytest.approx(3.0)
    assert read("sample_img_per_s") == 100.0
    assert read("sample_p95_ms") == pytest.approx(95.05e3)
    want = 100 * least_seconds(2e6, 1e4, "bfloat16") / 20e-9
    assert read("attn_roofline.sample") == pytest.approx(want)
    for m in ("launches.train", "mfu.train", "device_idle.train", "attn_roofline.train",
              "train_img_per_s"):
        assert read(m) is None                        # another kind of run
    tr.device = [d for d in tr.device if "attention" not in d[0]]
    assert read("attn_roofline.sample") is None       # no kernel found: no reading


def test_sg2_ops_roofline_reads_bytes():
    tr = Trace(device=[("void bias_act_fwd_vec<float>", 0, 1000),
                       ("row_shift_kernel", 1000, 2000)], host=[], window=(0, 4000), calls=1)
    tr.extra["kernel_bytes"] = [PEAK_BYTES * 1e-6, PEAK_BYTES * 0.5e-6]
    obs = dict(kind="train", chips=1, trace=tr)
    assert harness.reader("sg2_ops_roofline.train").read(obs) == pytest.approx(75.0)


def test_biggan_work_counts_match_hand_values():
    cfg = json.loads((harness.PB / "configs" / "icgan_biggan_res256.json").read_text())
    w = harness.work("icgan_biggan_res256")
    assert w.generator_flops_per_image(cfg) / 1e9 == pytest.approx(92.57, abs=0.005)
    assert w.train_flops_per_step(cfg, 32) / 1e12 == pytest.approx(23.57, abs=0.005)
    assert w.sample_attention_calls(cfg, 128) == [("fwd", (128, 4096, 1024, 48, 192))]
    calls = w.train_attention_calls(cfg, 32)
    assert sum(k == "fwd" for k, _ in calls) == 4 and sum(k == "bwd" for k, _ in calls) == 3
    flops, nbytes = w.attention_cost("fwd", (128, 4096, 1024, 48, 192))
    assert flops == 2.0 * 128 * 4096 * 1024 * 240
    assert least_seconds(flops, nbytes, "bfloat16") * 1e3 == pytest.approx(0.2606, abs=1e-4)
    flops, _ = w.attention_cost("bwd", (32, 4096, 1024, 48, 192))
    assert flops / PEAK_FLOPS["bfloat16"] * 1e3 == pytest.approx(0.1433, abs=1e-4)


def test_sg2_work_counts():
    cfg = json.loads((harness.PB / "configs" / "icgan_sg2ada_res256.json").read_text())
    w = harness.work("icgan_sg2ada_res256")
    main = w.step_flops(cfg, 16, False, False)
    assert w.step_flops(cfg, 16, True, False) - main == pytest.approx(
        8 * 4 * w.generator_flops(cfg))
    assert w.step_flops(cfg, 16, False, True) - main == pytest.approx(
        16 * (3 * w.discriminator_flops(cfg) + 2 * w.ada_flops(cfg)))
    assert 0.5e12 < main < 20e12
