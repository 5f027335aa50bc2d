"""sg2_ops_roofline.train: the least time of the bytes that the row shift
(B3) and the bias-activation forward and backward (B4) must move in the
profiled sub-window (from their arguments, each input byte read once and
each output byte written once; the work is memory-bound) over the device
time of the kernels that this file's pattern finds, in percent.  Where it
finds no kernel there is no reading."""

from peaks import PEAK_BYTES
from readers import roofline

PATTERN = r"row_shift|bias_act"


def read(obs):
    return roofline(obs, "train", PATTERN, "kernel_bytes", lambda b: b / PEAK_BYTES)
