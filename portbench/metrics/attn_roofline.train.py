"""attn_roofline.train: the least time of a train step's SA-GAN attention
work, forward and backward (operations and bytes from the shapes,
``work/``), over the device time of the kernels that this file's pattern
finds (B1 and B2), in percent.  Where it finds no kernel there is no
reading."""

from peaks import least_seconds
from readers import roofline

PATTERN = r"sagan_attention_fwd|attn_bwd_"


def read(obs):
    return roofline(obs, "train", PATTERN, "attention",
                    lambda c: least_seconds(c[2], c[3], "bfloat16"))
