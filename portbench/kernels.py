"""The benchmark's kernel classifier for the trace's ``breakdown``.

Kernel names are matched, in this order, against substrings.  cuDNN's
convolutions come before the matrix products, because their names hold
"gemm" too (``sm90_xmma_fprop_implicit_gemm_...``); a name with "gemm" and
no convolution mark, such as cuBLAS's ``sm80_xmma_gemm_...``, is a matrix
product.
"""

from __future__ import annotations

CLASSES = (
    ("attention forward B1", ("sagan_attention_fwd",)),
    ("attention backward B2", ("attn_bwd_",)),
    ("ADA row shift B3", ("row_shift",)),
    ("bias-activation B4 backward", ("bias_act_bwd",)),
    ("bias-activation B4", ("bias_act",)),
    ("collectives (NCCL)", ("nccl", "NCCL")),
    ("cuDNN NCHW<->NHWC transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convs (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve",
                       "conv", "Conv", "winograd", "fft")),
    ("matmuls (cuBLAS and others)", ("gemm", "Gemm", "gemv", "nvjet", "cutlass")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("host-device copies", ("Memcpy HtoD", "Memcpy DtoH")),
    ("copies and concatenation", ("copy", "Copy", "Cat", "Memcpy", "Memset")),
    ("pooling and resize", ("pool", "upsample")),
    ("elementwise", ("elementwise", "Elementwise")),
)


def kernel_class(name: str) -> str:
    for label, parts in CLASSES:
        if any(p in name for p in parts):
            return label
    return "other"
