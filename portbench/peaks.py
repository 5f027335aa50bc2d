"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the least time a piece
of work can take on it.  A card set below 700 W runs slower under load:
every run prints the card's power limit beside these peaks.
"""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations over the peak rate for ``dtype`` and the
    bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return (f"card: {out or 'unknown'}; peaks: bf16 {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, "
            f"f32 {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s, HBM {PEAK_BYTES / 1e12:.2f} TB/s "
            "(data sheet, 700 W)")
