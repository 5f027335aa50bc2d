"""TFHub BigGAN releases into the port, without TensorFlow: port of
``ic_gan_tpu/io/tfhub_import.py``.

The reference's ``BigGAN_PyTorch/TFHub/converter.py`` turns DeepMind's TFHub
BigGAN releases into main-repo state dicts in three hops: TF-session dump →
intermediate HDF5 of raw variables (``dump_tfhub_to_hdf5``, :49-81) → the
``biggan_v1`` naming (``TFHub2Pytorch``, :84-263) → the main BigGAN layout
(``convert_from_v1``, :266-391).  TF and TFHub are not needed here: this
module reads the variable dump (the reference's intermediate HDF5,
``biggan-{res}.h5``, an ``.npz`` of it, or any ``name → array`` mapping
with TFHub's names)
and writes the main-layout state dict in one hop (numpy, as the JAX
package), which the port's generator loads as it is
(``io/torch_import.py:load_generator_state_dict``).

All the reference's transform quirks are reproduced: EMA-suffixed reads,
the ccbn input reorder (``[y(128) | z_chunk]``, :345-357), the first
linear's TF→NCHW 4×4×C reshuffle (:358-380), the shared-embedding double
transpose (:382-385), and the per-resolution geometry of ``get_config``
(:393-427).  An ``.h5`` source needs ``h5py``, imported when one is read.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ic_gan_tpu_torch.models.biggan import BigGANConfig

# Upstream TFHub geometry (converter.py:394-396 + NUM_GBLOCK :87).
_GEOMETRY = {
    128: dict(dim_z=120, attn="64", blocks=5, attn_block=3),
    256: dict(dim_z=140, attn="128", blocks=6, attn_block=4),
    512: dict(dim_z=128, attn="64", blocks=7, attn_block=3),
}
_CH = 96
_SHARED = 128


def tfhub_config(resolution: int) -> BigGANConfig:
    """The upstream class-conditional BigGAN geometry (``get_config``,
    converter.py:393-427)."""
    g = _GEOMETRY[resolution]
    return BigGANConfig(
        resolution=resolution, n_classes=1000, G_ch=_CH, D_ch=_CH,
        dim_z=g["dim_z"], G_attn=g["attn"], D_attn=g["attn"],
        G_shared=True, shared_dim=_SHARED, hier=True,
        class_cond=True, instance_cond=False,
        SN_eps=1e-4, BN_eps=1e-4,
    )


def convert_tfhub_dump(tf_vars: Mapping[str, np.ndarray], resolution: int,
                       load_ema: bool = True) -> Dict[str, np.ndarray]:
    """TFHub variable dump → main-repo BigGAN ``G.state_dict()`` layout.

    ``tf_vars``: name → array with the dump's names
    (``module/Generator/GBlock_1/conv0/w/ema_b999900:0`` …) — an ``h5py.File``
    of the reference's intermediate HDF5 works directly.
    """
    g = _GEOMETRY[resolution]
    ema = "/ema_b999900" if load_ema else ""
    z_chunk = g["dim_z"] // (g["blocks"] + 1)

    def get(path: str, with_ema: bool = True) -> np.ndarray:
        key = f"{path}{ema if with_ema else ''}:0"
        arr = tf_vars[key]
        return np.asarray(arr[()] if hasattr(arr, "shape") and not
                          isinstance(arr, np.ndarray) else arr)

    sd: Dict[str, np.ndarray] = {}
    GEN = "module/Generator"

    def conv(out_name: str, tf_dir: str, bias: bool = True):
        # tf w (kh, kw, in, out) → torch OIHW (converter.py:169-176)
        sd[out_name + ".weight"] = np.transpose(get(f"{tf_dir}/w"), (3, 2, 0, 1))
        sd[out_name + ".u0"] = get(f"{tf_dir}/u0", with_ema=False).reshape(1, -1)
        if bias:
            sd[out_name + ".bias"] = get(f"{tf_dir}/b").reshape(-1)

    def bn_linear(out_name: str, tf_dir: str, reorder: bool):
        # tf w (in, out) → torch (out, in); ccbn inputs reorder from the
        # upstream [z_chunk | y] to the main repo's [y | z_chunk]
        # (converter.py:345-357).
        w = np.transpose(get(f"{tf_dir}/w"))
        if reorder:
            w = np.concatenate([w[:, -_SHARED:], w[:, :z_chunk]], axis=1)
        sd[out_name + ".weight"] = w
        sd[out_name + ".u0"] = get(f"{tf_dir}/u0", with_ema=False).reshape(1, -1)

    for i in range(g["blocks"]):
        tf_block = f"{GEN}/GBlock" + (f"_{i}" if i else "")
        # conv0→conv1, conv1→conv2 (converter.py:268 convnum_dict)
        conv(f"blocks.{i}.0.conv1", f"{tf_block}/conv0")
        conv(f"blocks.{i}.0.conv2", f"{tf_block}/conv1")
        conv(f"blocks.{i}.0.conv_sc", f"{tf_block}/conv_sc")
        for hyper, bn in (("HyperBN", "bn1"), ("HyperBN_1", "bn2")):
            bn_linear(f"blocks.{i}.0.{bn}.gain", f"{tf_block}/{hyper}/gamma",
                      reorder=True)
            bn_linear(f"blocks.{i}.0.{bn}.bias", f"{tf_block}/{hyper}/beta",
                      reorder=True)
            cr = f"{tf_block}/{hyper.replace('HyperBN', 'CrossReplicaBN')}"
            sd[f"blocks.{i}.0.{bn}.stored_mean"] = get(
                f"{cr}/accumulated_mean", with_ema=False)
            sd[f"blocks.{i}.0.{bn}.stored_var"] = get(
                f"{cr}/accumulated_var", with_ema=False)

    # Self-attention (converter.py:251-259, 288-299)
    a = g["attn_block"]
    attn = f"{GEN}/attention"
    for tf_name, me in (("theta", "theta"), ("phi", "phi"), ("g", "g"),
                        ("o_conv", "o")):
        conv(f"blocks.{a}.1.{me}", f"{attn}/{tf_name}", bias=False)
    sd[f"blocks.{a}.1.gamma"] = get(f"{attn}/gamma").reshape(())

    # First linear: TF flattens the 4×4×(16ch) output (H, W, C); the main
    # repo wants (C, H, W) row-major (converter.py:358-380).
    w = np.transpose(get(f"{GEN}/G_Z/G_linear/w"))  # (out, z_chunk)
    out_ch = _CH * 16
    sd["linear.weight"] = (w.reshape(4, 4, out_ch, -1)
                           .transpose(2, 0, 1, 3).reshape(-1, z_chunk))
    sd["linear.bias"] = (get(f"{GEN}/G_Z/G_linear/b")
                         .reshape(4, 4, out_ch).transpose(2, 0, 1).reshape(-1))
    sd["linear.u0"] = (get(f"{GEN}/G_Z/G_linear/u0", with_ema=False)
                       .reshape(4, 4, out_ch).transpose(2, 0, 1).reshape(1, -1))

    # Shared class embedding: tf (1000, 128) → permute → t() = identity
    # (converter.py:329,382-385).
    sd["shared.weight"] = get("module/linear/w")

    # Output layer: plain BN + final conv (converter.py:277-287).
    sbn = f"{GEN}/ScaledCrossReplicaBN"
    sd["output_layer.0.gain"] = get(f"{sbn}/gamma").reshape(-1)
    sd["output_layer.0.bias"] = get(f"{sbn}/beta").reshape(-1)
    sd["output_layer.0.stored_mean"] = get(f"{sbn}bn/accumulated_mean",
                                           with_ema=False)
    sd["output_layer.0.stored_var"] = get(f"{sbn}bn/accumulated_var",
                                          with_ema=False)
    conv("output_layer.2", f"{GEN}/conv_2d")
    return sd


def load_tfhub_generator(source, resolution: int, load_ema: bool = True, device=None
                         ) -> Tuple[torch.nn.Module, BigGANConfig]:
    """A TFHub BigGAN dump as the port's generator.

    ``source``: a path to the reference's intermediate ``biggan-{res}.h5``
    (its producer needs TFHub), a path to an ``.npz`` of the same names (for
    machines without ``h5py``), or a ``name → array`` mapping.  Returns
    ``(g, config)``, g on ``device`` (CUDA unless named) in eval mode,
    σ-foldable like any import; every weight and buffer of g is the dump's
    or synthesized from it (``_synthesize_missing_sn``)."""
    from ic_gan_tpu_torch.io.torch_import import load_generator_state_dict

    if isinstance(source, str) and source.endswith(".npz"):
        with np.load(source) as f:
            tf_vars = {k: f[k] for k in f.files}
    elif isinstance(source, str):
        import h5py

        with h5py.File(source, "r") as f:
            tf_vars = {k: np.asarray(v) for k, v in _walk_h5(f)}
    else:
        tf_vars = source
    cfg = tfhub_config(resolution)
    sd = convert_tfhub_dump(tf_vars, resolution, load_ema=load_ema)
    _synthesize_missing_sn(sd, cfg)
    g = load_generator_state_dict(sd, cfg, device=device)[0]
    return g.eval(), cfg


def _power_iterate(w2d: np.ndarray, u: np.ndarray, iters: int = 10):
    """σ and refined u for a reference-layout (out, in_flat) matrix."""
    for _ in range(iters):
        v = w2d.T @ u
        v /= np.linalg.norm(v) + 1e-12
        u = w2d @ v
        u /= np.linalg.norm(u) + 1e-12
    return float(u @ w2d @ v), u


def _synthesize_missing_sn(sd: Dict[str, np.ndarray], cfg: BigGANConfig):
    """Fill SN buffers the TFHub dump doesn't carry.

    The dump has no ``sv0`` anywhere and no ``u0`` for the shared embedding
    (the reference tolerates this via ``load_state_dict(strict=False)``,
    converter.py:452 — those buffers keep their init and power iteration
    repairs them over subsequent forwards). Eval mode recomputes σ from
    ``u``, so here they are synthesized *exactly* instead: converged power
    iteration on each weight."""
    from torch.nn.utils import skip_init

    from ic_gan_tpu_torch.models.biggan import Generator

    needed = {k for k in skip_init(Generator, cfg, device="meta").state_dict()
              if k.endswith((".u0", ".sv0"))}
    for key in sorted(needed):
        if key in sd:
            continue
        prefix = key.rsplit(".", 1)[0]
        w = np.asarray(sd[prefix + ".weight"], np.float64)
        w2d = w.reshape(w.shape[0], -1)
        if key.endswith(".u0"):
            u0 = np.ones(w2d.shape[0]) / np.sqrt(w2d.shape[0])
            _, u = _power_iterate(w2d, u0, iters=30)
            sd[key] = u.reshape(1, -1).astype(np.float32)
        else:
            u0 = sd.get(prefix + ".u0")
            if u0 is None:
                _, u0 = _power_iterate(
                    w2d, np.ones(w2d.shape[0]) / np.sqrt(w2d.shape[0]), 30)
            u = np.asarray(u0, np.float64).reshape(-1)
            # σ exactly as the runtime derives it from the stored u:
            # v = normalize(Wᵀu), σ = uᵀWv (no u advance).
            v = w2d.T @ u
            v /= np.linalg.norm(v) + 1e-12
            sd[key] = np.asarray([u @ w2d @ v], np.float32)


def _walk_h5(group, prefix: str = ""):
    import h5py

    for key, item in group.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(item, h5py.Group):
            yield from _walk_h5(item, path)
        else:
            yield path, item
