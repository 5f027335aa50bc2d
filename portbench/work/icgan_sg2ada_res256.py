"""Work counts of the IC-GAN StyleGAN2-ADA configurations: operations of a
train step of each schedule variant, from the configuration's widths.  The
layer shapes are read off the frozen reference's G and D built on the
``meta`` device from the configuration file, so no change to the port can
change the count.  Multiply-adds count twice.
"""

from __future__ import annotations

import math

from peaks import PEAK_FLOPS  # noqa: F401  (the metric readers' peaks)


def _nets(cfg: dict):
    from reference.icgan_ref.models import stylegan2 as sg2

    mcfg = sg2.StyleGAN2Config(**cfg["model"])
    return sg2, mcfg, sg2.Generator(mcfg, device="meta"), sg2.Discriminator(mcfg, device="meta")


def _fc(sg2, net) -> float:
    return sum(2.0 * m.weight.numel() for m in net.modules()
               if isinstance(m, sg2.FullyConnected))


def generator_flops(cfg: dict) -> float:
    """One image through G: the FCs (mapping and affines), the modulated
    convs (an up-conv as its 3×3 phase convs at the input's size), torgb."""
    sg2, _, g, _ = _nets(cfg)
    total = _fc(sg2, g)
    for r in g.synthesis.block_resolutions:
        blk = getattr(g.synthesis, f"b{r}")
        for name in ("conv0", "conv1"):
            layer = getattr(blk, name, None)
            if layer is not None:
                o, i, k, _ = layer.weight.shape
                total += 2.0 * k * k * i * o * r * r
        if hasattr(blk, "torgb"):
            o, i = blk.torgb.weight.shape[:2]
            total += 2.0 * i * o * r * r
    return total


def discriminator_flops(cfg: dict) -> float:
    """One image through D: fromrgb, the 3×3 convs, the strided 6×6 and 4×4
    composite convs, the epilogue and the FCs."""
    sg2, _, _, d = _nets(cfg)
    total = _fc(sg2, d)
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


def ada_flops(cfg: dict) -> float:
    """The ADA warp's two scale products per image (rows × L × 2L each) on
    its padded canvas."""
    m = cfg["model"]
    res, c = m["img_resolution"], m["img_channels"]
    canvas = 2 * (res + 2 * (math.ceil(res / 4) + 6))
    return 2 * 2.0 * c * canvas * canvas * (2 * canvas)


def step_flops(cfg: dict, mb: int, do_pl: bool, do_r1: bool) -> float:
    """One step at batch ``mb``: a backward costs twice its forward, one that
    forms only input gradients once, differentiating a first gradient twice
    that gradient.  Main: G phase 3·G + 2·D + 2·ADA, D phase G + 2·(3·D +
    ADA); path length adds G + G + 2·G on mb/2, R1 adds D + 2·D + 2·ADA on
    mb."""
    gf, df, af = generator_flops(cfg), discriminator_flops(cfg), ada_flops(cfg)
    total = mb * (4 * gf + 8 * df + 4 * af)
    if do_pl:
        total += (mb // 2) * 4 * gf
    if do_r1:
        total += mb * (3 * df + 2 * af)
    return total
