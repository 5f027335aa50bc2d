"""attn_roofline.sample: the least time of the sampler's SA-GAN attention
work (operations and bytes from its shapes, ``work/``) over the device time
of the kernels that this file's pattern finds, in percent.  Where the
pattern finds no kernel there is no reading."""

from peaks import least_seconds
from readers import roofline

PATTERN = r"sagan_attention_fwd"


def read(obs):
    return roofline(obs, "sample", PATTERN, "attention",
                    lambda c: least_seconds(c[2], c[3], "bfloat16"))
