"""mfu.sample: the model's operations (from the configuration's widths,
``work/``) over the host-timed stretch of the traced run, as a percentage
of the chips' bf16 peak (989 TFLOP/s a chip, data sheet)."""

from readers import mfu


def read(obs):
    return mfu(obs, "sample")
