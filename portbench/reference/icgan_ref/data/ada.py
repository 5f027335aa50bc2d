"""ADA, adaptive discriminator augmentation, in PyTorch (NCHW).

Port of ``ic_gan_tpu/data/ada.py`` (reference ``stylegan2_ada_pytorch/
training/augment.py:279-829``): pixel blitting (x-flip, 90° rotations,
integer translation), general geometry (isotropic and anisotropic scaling,
rotation, fractional translation) executed as one composed inverse affine
with wavelet-filtered resampling, colour transforms as 4×4 matrices, per-band
image filtering, additive noise and cutout, each gated per sample by ``p``.

As in the JAX package the geometric stage pads by a static margin
(``geom_margin_frac`` of the image), and every transform of the spec is
computed whatever ``p`` is (a gate only selects the identity).  The warp is
``geom_impl="fast"``, the two-pass warp of ``data/fast_warp.py`` whose shear
passes launch kernel B3 on the card, or ``"exact"``, the bilinear gather of
``grid_sample_bilinear``; ``"auto"`` takes fast on CUDA tensors and exact on
the CPU, as the JAX package takes fast on the TPU.  Draws come from an
explicit ``torch.Generator``; ``debug_percentile`` replaces every draw by its
percentile, the reference's deterministic testing hook.  Everything is
differentiable in the images, to any order.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F

from reference.icgan_ref.data.fast_warp import affine_warp
from reference.icgan_ref.ops.resample import downsample2d, setup_filter, upsample2d

# Symlet wavelets of the reference (augment.py:24-50).
WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036, -0.007800708325034148],
}


# --- homogeneous matrices (augment.py:198-277), batched over (N,) tensors ----------

def _stack3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def translate2d_inv(tx, ty):
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return _stack3([[one, zero, -tx], [zero, one, -ty], [zero, zero, one]])


def translate2d(tx, ty):
    return translate2d_inv(-tx, -ty)


def scale2d_inv(sx, sy):
    one, zero = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack3([[1.0 / sx, zero, zero], [zero, 1.0 / sy, zero], [zero, zero, one]])


def scale2d(sx, sy):
    return scale2d_inv(1.0 / sx, 1.0 / sy)


def rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    return _stack3([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def rotate2d_inv(theta):
    return rotate2d(-theta)


def _eye4(n, like):
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(n, 4, 4).clone()


def translate3d(tx, ty, tz):
    m = _eye4(tx.shape[0], tx)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = tx, ty, tz
    return m


def scale3d(sx, sy, sz):
    m = _eye4(sx.shape[0], sx)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = sx, sy, sz
    return m


def rotate3d(v, theta):
    """Rotation about the unit axis ``v`` (3 floats) by ``theta`` (N,)."""
    vx, vy, vz = (float(a) for a in v)
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1.0 - c
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rows = [
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, zero],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, zero],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, zero],
        [zero, zero, zero, one],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _build_fbank() -> np.ndarray:
    """The 4-band sym2 filter bank (augment.py:380-399)."""
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:(fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank.astype(np.float32)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, ``align_corners=False``, as
    gathers and arithmetic (differentiable to any order, unlike
    ``F.grid_sample``'s backward).  img (N, C, H, W); grid (N, Ho, Wo, 2),
    normalized (x, y) in [-1, 1] → (N, C, Ho, Wo)."""
    n, c, h, w = img.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = img.reshape(n, c, h * w)

    def corner(yy, xx):
        valid = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)).to(img.dtype)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).to(torch.int64).reshape(n, 1, -1)
        v = torch.gather(flat, 2, idx.expand(n, c, -1)).reshape(n, c, *gx.shape[1:])
        return v * valid[:, None]

    return (corner(y0, x0) * (1 - wx) * (1 - wy) + corner(y0, x0 + 1) * wx * (1 - wy)
            + corner(y0 + 1, x0) * (1 - wx) * wy + corner(y0 + 1, x0 + 1) * wx * wy)


class AugmentPipe:
    """Callable ADA pipe: ``pipe(images, p, generator=None,
    debug_percentile=None) -> images``, images (N, C, H, W).

    The constructor mirrors the reference's probability multipliers
    (``augment.py:281-310``); the published specs (``train.py:452-522``) are
    ``AugmentPipe.from_spec``.
    """

    SPECS = {
        "blit": dict(xflip=1, rotate90=1, xint=1),
        "geom": dict(scale=1, rotate=1, aniso=1, xfrac=1),
        "color": dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
        "filter": dict(imgfilter=1),
        "noise": dict(noise=1),
        "cutout": dict(cutout=1),
    }
    SPECS["bg"] = {**SPECS["blit"], **SPECS["geom"]}
    SPECS["bgc"] = {**SPECS["bg"], **SPECS["color"]}
    SPECS["bgcf"] = {**SPECS["bgc"], **SPECS["filter"]}
    SPECS["bgcfn"] = {**SPECS["bgcf"], **SPECS["noise"]}
    SPECS["bgcfnc"] = {**SPECS["bgcfn"], **SPECS["cutout"]}

    def __init__(self, xflip=0, rotate90=0, xint=0, xint_max=0.125,
                 scale=0, rotate=0, aniso=0, xfrac=0,
                 scale_std=0.2, rotate_max=1.0, aniso_std=0.2, xfrac_std=0.125,
                 brightness=0, contrast=0, lumaflip=0, hue=0, saturation=0,
                 brightness_std=0.2, contrast_std=0.5, hue_max=1.0, saturation_std=1.0,
                 imgfilter=0, imgfilter_bands=(1, 1, 1, 1), imgfilter_std=1.0,
                 noise=0, cutout=0, noise_std=0.1, cutout_size=0.5,
                 geom_margin_frac=0.25, geom_impl="auto"):
        if geom_impl not in ("auto", "fast", "exact"):
            raise ValueError(f"geom_impl must be auto, fast or exact, got {geom_impl!r}")
        self.__dict__.update({k: v for k, v in locals().items() if k != "self"})
        self.Hz_geom = setup_filter(WAVELETS["sym6"])
        self.Hz_fbank = _build_fbank()
        self._host = {
            "Hz_geom": self.Hz_geom, "Hz_fbank": torch.from_numpy(self.Hz_fbank),
            "v_luma": torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64) / math.sqrt(3),
            "expected_power": torch.tensor([10.0, 1.0, 1.0, 1.0], dtype=torch.float64) / 13.0,
        }
        self._cache = {}

    def _on(self, name, device, dtype=torch.float32) -> torch.Tensor:
        """The constant ``name`` on ``device``, copied there once: a copy
        from host memory waits for the device, so none runs per call."""
        key = (name, device, dtype)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = self._host[name].to(device=device, dtype=dtype)
        return t

    @classmethod
    def from_spec(cls, spec: str = "bgc", **kw):
        return cls(**cls.SPECS[spec], **kw)

    def __call__(self, images: torch.Tensor, p, generator=None,
                 debug_percentile=None) -> torch.Tensor:
        """``p``: a float or a 0-d tensor (read on the device, no sync)."""
        n, c, h, w = images.shape
        dev = images.device
        md = torch.promote_types(images.dtype, torch.float32)  # draws and matrices
        dp = debug_percentile
        p = p.to(device=dev, dtype=md) if torch.is_tensor(p) else \
            torch.full((), float(p), device=dev, dtype=md)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev, dtype=md)

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev, dtype=md)

        def full(shape, value):
            return torch.full(shape, float(value), device=dev, dtype=md)

        erfinv = (lambda: float(scipy.special.erfinv(dp * 2 - 1))) if dp is not None else None

        # ---- pixel blitting and geometry: one composed inverse affine ----
        G_inv = torch.eye(3, device=dev, dtype=md).expand(n, 3, 3)
        used_geom = False
        if self.xflip > 0:
            i = torch.floor(uniform(n) * 2)
            i = torch.where(uniform(n) < self.xflip * p, i, 0.0)
            if dp is not None:
                i = full((n,), np.floor(dp * 2))
            G_inv = G_inv @ scale2d_inv(1 - 2 * i, torch.ones_like(i))
            used_geom = True
        if self.rotate90 > 0:
            i = torch.floor(uniform(n) * 4)
            i = torch.where(uniform(n) < self.rotate90 * p, i, 0.0)
            if dp is not None:
                i = full((n,), np.floor(dp * 4))
            G_inv = G_inv @ rotate2d_inv(-np.pi / 2 * i)
            used_geom = True
        if self.xint > 0:
            t = (uniform(n, 2) * 2 - 1) * self.xint_max
            t = torch.where(uniform(n, 1) < self.xint * p, t, 0.0)
            if dp is not None:
                t = full((n, 2), (dp * 2 - 1) * self.xint_max)
            G_inv = G_inv @ translate2d_inv(torch.round(t[:, 0] * w), torch.round(t[:, 1] * h))
            used_geom = True
        if self.scale > 0:
            s = torch.exp2(normal(n) * self.scale_std)
            s = torch.where(uniform(n) < self.scale * p, s, 1.0)
            if dp is not None:
                s = full((n,), 2 ** (erfinv() * self.scale_std))
            G_inv = G_inv @ scale2d_inv(s, s)
            used_geom = True
        p_rot = 1 - torch.sqrt(torch.clamp(1 - self.rotate * p, 0.0, 1.0))
        if self.rotate > 0:
            theta = (uniform(n) * 2 - 1) * np.pi * self.rotate_max
            theta = torch.where(uniform(n) < p_rot, theta, 0.0)
            if dp is not None:
                theta = full((n,), (dp * 2 - 1) * np.pi * self.rotate_max)
            G_inv = G_inv @ rotate2d_inv(-theta)
            used_geom = True
        if self.aniso > 0:
            s = torch.exp2(normal(n) * self.aniso_std)
            s = torch.where(uniform(n) < self.aniso * p, s, 1.0)
            if dp is not None:
                s = full((n,), 2 ** (erfinv() * self.aniso_std))
            G_inv = G_inv @ scale2d_inv(s, 1.0 / s)
            used_geom = True
        if self.rotate > 0:
            theta = (uniform(n) * 2 - 1) * np.pi * self.rotate_max
            theta = torch.where(uniform(n) < p_rot, theta, 0.0)
            if dp is not None:
                theta = full((n,), 0.0)
            G_inv = G_inv @ rotate2d_inv(-theta)
        if self.xfrac > 0:
            t = normal(n, 2) * self.xfrac_std
            t = torch.where(uniform(n, 1) < self.xfrac * p, t, 0.0)
            if dp is not None:
                t = full((n, 2), erfinv() * self.xfrac_std)
            G_inv = G_inv @ translate2d_inv(t[:, 0] * w, t[:, 1] * h)
            used_geom = True
        if used_geom:
            images = self._execute_geom(images, G_inv)

        # ---- colour: one 4×4 matrix per sample ----
        eye4 = torch.eye(4, device=dev, dtype=md)
        Cm = eye4.expand(n, 4, 4)
        used_color = False
        v_luma = self._on("v_luma", dev, md)
        vv = torch.outer(v_luma, v_luma)
        if self.brightness > 0:
            b = normal(n) * self.brightness_std
            b = torch.where(uniform(n) < self.brightness * p, b, 0.0)
            if dp is not None:
                b = full((n,), erfinv() * self.brightness_std)
            Cm = translate3d(b, b, b) @ Cm
            used_color = True
        if self.contrast > 0:
            s = torch.exp2(normal(n) * self.contrast_std)
            s = torch.where(uniform(n) < self.contrast * p, s, 1.0)
            if dp is not None:
                s = full((n,), 2 ** (erfinv() * self.contrast_std))
            Cm = scale3d(s, s, s) @ Cm
            used_color = True
        if self.lumaflip > 0:
            i = torch.floor(uniform(n, 1, 1) * 2)
            i = torch.where(uniform(n, 1, 1) < self.lumaflip * p, i, 0.0)
            if dp is not None:
                i = full((n, 1, 1), np.floor(dp * 2))
            Cm = (eye4 - 2 * vv * i) @ Cm
            used_color = True
        if self.hue > 0 and c > 1:
            theta = (uniform(n) * 2 - 1) * np.pi * self.hue_max
            theta = torch.where(uniform(n) < self.hue * p, theta, 0.0)
            if dp is not None:
                theta = full((n,), (dp * 2 - 1) * np.pi * self.hue_max)
            Cm = rotate3d([1 / math.sqrt(3)] * 3, theta) @ Cm
            used_color = True
        if self.saturation > 0 and c > 1:
            s = torch.exp2(normal(n, 1, 1) * self.saturation_std)
            s = torch.where(uniform(n, 1, 1) < self.saturation * p, s, 1.0)
            if dp is not None:
                s = full((n, 1, 1), 2 ** (erfinv() * self.saturation_std))
            Cm = (vv + (eye4 - vv) * s) @ Cm
            used_color = True
        if used_color:
            # In the matrices' type, as the JAX pipe promotes (bf16 images
            # leave in float32).
            images = images.to(md)
            if c == 3:
                images = (torch.einsum("nij,njhw->nihw", Cm[:, :3, :3], images)
                          + Cm[:, :3, 3][:, :, None, None])
            elif c == 1:
                cm = Cm[:, :3, :].mean(dim=1)                        # (N, 4)
                images = images * cm[:, :3].sum(dim=1)[:, None, None, None] \
                    + cm[:, 3][:, None, None, None]

        # ---- image-space filtering: per-band amplification ----
        if self.imgfilter > 0:
            num_bands = self.Hz_fbank.shape[0]
            expected_power = self._on("expected_power", dev, md)
            g = full((n, num_bands), 1.0)
            for i, band_strength in enumerate(self.imgfilter_bands):
                t_i = torch.exp2(normal(n) * self.imgfilter_std)
                t_i = torch.where(uniform(n) < self.imgfilter * p * band_strength, t_i, 1.0)
                if dp is not None:
                    t_i = full((n,), 2 ** (erfinv() * self.imgfilter_std)
                               if band_strength > 0 else 1.0)
                t = full((n, num_bands), 1.0)
                t[:, i] = t_i
                t = t / (expected_power * t.square()).sum(dim=-1, keepdim=True).sqrt()
                g = g * t
            hz = (g @ self._on("Hz_fbank", dev, md)).to(images.dtype)
            taps, pad = hz.shape[1], self.Hz_fbank.shape[1] // 2
            # Batch folded into channels: one depthwise filter per sample.
            x = F.pad(images.reshape(1, n * c, h, w), (pad, pad, pad, pad), mode="reflect")
            ker = hz.repeat_interleave(c, dim=0)                      # (N·C, taps)
            x = F.conv2d(x, ker[:, None, :, None], groups=n * c)
            x = F.conv2d(x, ker[:, None, None, :], groups=n * c)
            images = x.reshape(n, c, h, w)

        # ---- corruptions ----
        if self.noise > 0:
            sigma = normal(n, 1, 1, 1).abs() * self.noise_std
            sigma = torch.where(uniform(n, 1, 1, 1) < self.noise * p, sigma, 0.0)
            if dp is not None:
                sigma = full((n, 1, 1, 1), scipy.special.erfinv(dp) * self.noise_std)
            images = images + normal(*images.shape) * sigma
        if self.cutout > 0:
            size = torch.where(uniform(n, 1, 1, 1) < self.cutout * p,
                               full((n, 2, 1, 1), self.cutout_size), 0.0)
            center = uniform(n, 2, 1, 1)
            if dp is not None:
                size = full((n, 2, 1, 1), self.cutout_size)
                center = full((n, 2, 1, 1), dp)
            coord_x = torch.arange(w, device=dev).reshape(1, 1, -1)
            coord_y = torch.arange(h, device=dev).reshape(1, -1, 1)
            mask_x = ((coord_x + 0.5) / w - center[:, 0]).abs() >= size[:, 0] / 2
            mask_y = ((coord_y + 0.5) / h - center[:, 1]).abs() >= size[:, 1] / 2
            images = images * (mask_x | mask_y).to(images.dtype)[:, None]
        return images

    # -- the geometric stage (augment.py:540-607) ------------------------------------

    def _execute_geom(self, images, G_inv):
        n, c, h, w = images.shape
        dev = images.device
        md = G_inv.dtype
        f = self._on("Hz_geom", dev)
        hz_pad = self.Hz_geom.shape[0] // 4
        # The static margin (module docstring).
        mx = min(int(np.ceil(w * self.geom_margin_frac)) + hz_pad * 2, w - 1)
        my = min(int(np.ceil(h * self.geom_margin_frac)) + hz_pad * 2, h - 1)
        images = F.pad(images, (mx, mx, my, my), mode="reflect")

        # Upsample 2× with the orthogonal wavelet filter.
        images = upsample2d(images, f, up=2)
        const = lambda v: torch.full((n,), float(v), device=dev, dtype=md)  # noqa: E731
        two, half = const(2.0), const(-0.5)
        G_inv = scale2d(two, two) @ G_inv @ scale2d_inv(two, two)
        G_inv = translate2d(half, half) @ G_inv @ translate2d_inv(half, half)

        # The output grid has the warp input's padded size.
        hp, wp = h + 2 * my, w + 2 * mx
        in_h, in_w = images.shape[2], images.shape[3]
        G_inv = (scale2d(const(2.0 / in_w), const(2.0 / in_h)) @ G_inv
                 @ scale2d_inv(const(2.0 / (wp * 2)), const(2.0 / (hp * 2))))
        fast = self.geom_impl == "fast" or (self.geom_impl == "auto" and dev.type == "cuda")
        if fast and in_h == in_w:
            # The normalized-coordinate affine in pixels:
            # px = (G·[x_n, y_n, 1] + 1)·in/2 − 0.5 with x_n = (2·xo + 1)/Wo − 1.
            ho, wo = hp * 2, wp * 2
            G2 = G_inv[:, :2, :]
            a = G2[:, 0, 0] * (in_w / wo)
            b = G2[:, 0, 1] * (in_w / ho)
            tx = (in_w / 2.0) * (G2[:, 0, 0] * (1.0 / wo - 1.0) + G2[:, 0, 1] * (1.0 / ho - 1.0)
                                 + G2[:, 0, 2] + 1.0) - 0.5
            cc = G2[:, 1, 0] * (in_h / wo)
            d = G2[:, 1, 1] * (in_h / ho)
            ty = (in_h / 2.0) * (G2[:, 1, 0] * (1.0 / wo - 1.0) + G2[:, 1, 1] * (1.0 / ho - 1.0)
                                 + G2[:, 1, 2] + 1.0) - 0.5
            A_px = torch.stack([torch.stack([a, b], -1), torch.stack([cc, d], -1)], dim=1)
            images = affine_warp(images, A_px, torch.stack([tx, ty], -1))
        else:
            # affine_grid(align_corners=False): output pixel centres in [-1, 1].
            ys = (2.0 * torch.arange(hp * 2, device=dev, dtype=md) + 1.0) / (hp * 2) - 1.0
            xs = (2.0 * torch.arange(wp * 2, device=dev, dtype=md) + 1.0) / (wp * 2) - 1.0
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (Ho, Wo, 3)
            grid = torch.einsum("nij,hwj->nhwi", G_inv[:, :2, :], base)
            images = grid_sample_bilinear(images, grid.to(images.dtype))

        # Downsample and crop back to (H, W).
        images = downsample2d(images, f, down=2, padding=-hz_pad * 2, flip_filter=True)
        y0 = (images.shape[2] - h) // 2
        x0 = (images.shape[3] - w) // 2
        return images[:, :, y0:y0 + h, x0:x0 + w]
