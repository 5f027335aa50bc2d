"""Work counts of the IC-GAN BigGAN configurations, from the configuration
file's widths (``cfg["model"]``) and the frozen reference's channel tables:
operations of G and of a train step, and the SA-GAN attention calls with
their operations and bytes.  Multiply-adds count twice.
"""

from __future__ import annotations

from peaks import ITEM_BYTES, PEAK_FLOPS  # noqa: F401  (the metric readers' peaks)
from reference.icgan_ref.models.biggan import d_arch, g_arch

DTYPE = "bfloat16"


def _g_arch(m):
    return g_arch(m["resolution"], m["G_ch"], m["G_attn"])


def _d_arch(m):
    return d_arch(m["resolution"], m["D_ch"], m["D_attn"])


def _attn_flops(hw: int, c: int) -> float:
    """θ/φ/g 1×1 convs, the pooled keys, the two products and the output
    conv of one SA-GAN block over an hw-pixel map of c channels."""
    c8, c2 = c // 8, c // 2
    return 2.0 * hw * (c * (2 * c8 + c2) + hw // 4 * (c8 + c2) + c2 * c)


def generator_flops_per_image(cfg: dict) -> float:
    """One image through G: the up-convs (4 taps per output pixel of the
    polyphase form), the 3×3 and 1×1 convs, the attention blocks and the
    output conv; the linears and the batch-norm gains are left out (under
    0.1 %)."""
    m = cfg["model"]
    arch = _g_arch(m)
    total, r = 0.0, m["bottom_width"]
    for cin, cout, attn in zip(arch["in_channels"], arch["out_channels"], arch["attention"]):
        hw = (2 * r) ** 2
        total += 2 * hw * cout * (4 * cin + 9 * cout) + 2 * r * r * cin * cout
        if attn:
            total += _attn_flops(hw, cout)
        r *= 2
    return total + 2 * r * r * 9 * arch["out_channels"][-1] * 3


def discriminator_flops_per_image(cfg: dict) -> float:
    """One image through D: the wide 3×3 conv1, conv2 with its average pool
    as a 4×4 stride-2 conv, the 1×1 shortcuts after the pool and the
    attention blocks; the linears are left out."""
    m = cfg["model"]
    arch = _d_arch(m)
    total, r = 0.0, m["resolution"]
    for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
        down = arch["downsample"][i]
        r_out = r // 2 if down else r
        total += 2 * r * r * 9 * cin * cout
        total += 2 * r_out * r_out * (16 if down else 9) * cout * cout
        if cin != cout or down:
            total += 2 * r_out * r_out * cin * cout
        if arch["attention"][i]:
            total += _attn_flops(r_out * r_out, cout)
        r = r_out
    return total


def train_flops_per_step(cfg: dict, mb: int) -> float:
    """One train step at microbatch ``mb`` (one D step, no accumulation): a
    backward costs twice its forward, half of that for the input gradients.
    D phase: G forward on mb, D forward and backward on 2·mb; G phase: G
    forward and backward, D forward and its input gradients, on mb."""
    g, d = generator_flops_per_image(cfg), discriminator_flops_per_image(cfg)
    return mb * ((g + 2 * 3 * d) + (3 * g + 2 * d))


def _attention_shapes(cfg: dict, net: str, n: int) -> list:
    """(N, Lq, Lk, d, dv) of each attention block of G or D on n images."""
    m = cfg["model"]
    if net == "G":
        arch = _g_arch(m)
        res = arch["resolution"]
    else:
        arch = _d_arch(m)
        res = arch["resolution"]
    return [(n, r * r, r * r // 4, c // 8, c // 2)
            for c, r, a in zip(arch["out_channels"], res, arch["attention"]) if a]


def attention_cost(kind: str, shape) -> tuple:
    """(operations, bytes) that softmax(θφᵀ)·g (``"fwd"``) or its three
    gradients (``"bwd"``: the logits again, dp, dθ, dφ, dg) need, each input
    read once and each output written once, in bf16."""
    n, lq, lk, d, dv = shape
    inputs = n * (lq * d + lk * d + lk * dv)
    if kind == "fwd":
        return 2.0 * n * lq * lk * (d + dv), ITEM_BYTES[DTYPE] * (inputs + n * lq * dv)
    grads = n * (lq * d + lk * d + lk * dv)
    return (2.0 * n * lq * lk * (3 * d + 2 * dv),
            ITEM_BYTES[DTYPE] * (inputs + n * lq * dv + grads))


def sample_attention_calls(cfg: dict, batch: int) -> list:
    """(kind, shape) of the attention calls of one sampler batch."""
    return [("fwd", s) for s in _attention_shapes(cfg, "G", batch)]


def train_attention_calls(cfg: dict, mb: int) -> list:
    """(kind, shape) of the attention calls of one train step: the D phase
    runs G on mb (no gradient) and D forward and backward on 2·mb; the G
    phase runs G and D forward and backward on mb."""
    g, d2, d1 = (_attention_shapes(cfg, "G", mb), _attention_shapes(cfg, "D", 2 * mb),
                 _attention_shapes(cfg, "D", mb))
    fwd = g + d2 + g + d1
    bwd = d2 + d1 + g
    return [("fwd", s) for s in fwd] + [("bwd", s) for s in bwd]
