"""Qualitative sheets: sample sheets, interpolation sheets and StyleGAN2
style-mixing grids.  Port of ``ic_gan_tpu/cli/visualize.py``.

Reference: ``BigGAN_PyTorch/utils.py:1402-1562`` (``sample_sheet``, one row
per conditioning; ``interp_sheet``, z and conditioning interpolation with
the ``fix_z``/``fix_y`` modes), ``BigGAN_PyTorch/sample.py`` (the
``--sample_sheets``/``--sample_interps``/``--sample_random`` flags,
``utils.py:882-940``) and ``stylegan2_ada_pytorch/style_mixing.py`` (the
row/column seed grid with style crossover).

    python -m ic_gan_tpu_torch.cli.visualize --json_config cfg.json \\
        --set stored_features=feats.npy sample_sheets=true \\
              sample_interps=true out_dir=sheets/ [--device cuda]

    python -m ic_gan_tpu_torch.cli.visualize --set backbone=stylegan2 \\
        network_pkl=net.pkl mode=style_mixing row_seeds=85,100,75 \\
        col_seeds=55,821 col_styles=0-6 out_dir=sheets/

z and the sheets' instance draws come from ``torch.Generator``s seeded
``seed`` (a style-mixing grid: one seeded by each row and column seed), on
the CPU, so a sheet is the same on every device; class labels and the
random sheet's instances come from numpy streams, as in the JAX package.
The sheets run through the deployment sampler (``load_model_inference``):
σ folded, in fixed batches.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ic_gan_tpu_torch.cli.inference import save_image_grid


def _randn(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


def _randint(shape, high: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator)


def _numpy(images) -> np.ndarray:
    if torch.is_tensor(images):
        images = images.detach().float().cpu().numpy()
    return np.asarray(images)


def sample_sheet(
    apply_fn: Callable,
    dim_z: int,
    conditionings: Sequence,
    samples_per_cond: int = 8,
    z_var: float = 1.0,
    seed: int = 0,
    path: Optional[str] = None,
) -> np.ndarray:
    """One row per conditioning (class label or instance feature), fresh z
    per sample (ref ``utils.py:1402-1460``).  ``conditionings``: (label,
    feats) pairs, either may be None.  ``apply_fn(z, label, feats)`` →
    NHWC images."""
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for label, feats in conditionings:
        z = _randn((samples_per_cond, dim_z), gen) * math.sqrt(z_var)
        lab = None if label is None else np.repeat(
            np.asarray(label)[None], samples_per_cond, axis=0
        ).reshape(samples_per_cond, *np.shape(label))
        f = None if feats is None else np.repeat(np.asarray(feats)[None], samples_per_cond, 0)
        rows.append(_numpy(apply_fn(z, lab, f)))
    sheet = np.concatenate(rows)
    if path:
        save_image_grid(sheet, path, nrow=samples_per_cond)
    return sheet


def interp_sheet(
    apply_fn: Callable,
    dim_z: int,
    num_midpoints: int = 8,
    num_rows: int = 4,
    fix_z: bool = False,
    fix_feats: bool = False,
    feats_bank: Optional[np.ndarray] = None,
    labels_bank: Optional[np.ndarray] = None,
    z_var: float = 1.0,
    seed: int = 0,
    path: Optional[str] = None,
) -> np.ndarray:
    """Interpolation sheet (ref ``interp_sheet``, ``utils.py:1466-1562``):
    each row interpolates z and/or the instance feature between two
    endpoints in ``num_midpoints`` + 2 steps; ``fix_z`` holds z across the
    row, ``fix_feats`` the conditioning.  A class-conditional model gets one
    label per row from ``labels_bank`` (integer labels cannot be lerped; the
    reference interpolates the class embedding, the JAX package's
    simplification is kept)."""
    gen = torch.Generator().manual_seed(seed)
    n, steps = num_rows, num_midpoints + 2
    t = torch.linspace(0.0, 1.0, steps)[None, :, None]
    scale = math.sqrt(z_var)
    z_a = _randn((n, 1, dim_z), gen) * scale
    if fix_z:
        zs = z_a.expand(n, steps, dim_z)
    else:
        z_b = _randn((n, 1, dim_z), gen) * scale
        zs = z_a + (z_b - z_a) * t

    feats = None
    if feats_bank is not None:
        bank = torch.as_tensor(np.asarray(feats_bank, np.float32))
        idx = _randint((n, 2), bank.shape[0], gen)
        f_a, f_b = bank[idx[:, 0]][:, None, :], bank[idx[:, 1]][:, None, :]
        feats = f_a.expand(n, steps, bank.shape[1]) if fix_feats else f_a + (f_b - f_a) * t

    zs_flat = zs.reshape(n * steps, dim_z)
    f_flat = None if feats is None else feats.reshape(n * steps, -1)
    lab_flat = None
    if labels_bank is not None:
        bank = np.asarray(labels_bank).reshape(-1)
        row_labels = bank[np.random.RandomState(seed).randint(0, len(bank), n)]
        lab_flat = np.repeat(row_labels, steps)
    imgs = _numpy(apply_fn(zs_flat, lab_flat, f_flat))
    if path:
        save_image_grid(imgs, path, nrow=steps)
    return imgs


def style_mixing_grid(
    map_ws: Callable,
    synthesize: Callable,
    z_dim: int,
    row_seeds: Sequence[int],
    col_seeds: Sequence[int],
    col_styles: Sequence[int] = (0, 1, 2, 3, 4, 5, 6),
    cond_feats: Optional[np.ndarray] = None,
    truncation_psi: float = 1.0,
    path: Optional[str] = None,
) -> np.ndarray:
    """StyleGAN2 style-mixing grid (ref ``style_mixing.py:28-86``): rows keep
    their coarse styles, columns inject ``col_styles`` from the column
    seed.  ``map_ws(z, feats)`` → (S, num_ws, w_dim) (truncated by the
    caller's ``truncation_psi``); ``synthesize(ws)`` → NHWC images."""
    all_seeds = list(dict.fromkeys(list(row_seeds) + list(col_seeds)))
    zs = torch.stack([_randn((z_dim,), torch.Generator().manual_seed(s)) for s in all_seeds])
    f = None
    if cond_feats is not None:
        f = torch.as_tensor(np.asarray(cond_feats, np.float32))[None].expand(len(all_seeds), -1)
    ws = map_ws(zs, f)
    w_by_seed = {s: ws[i] for i, s in enumerate(all_seeds)}
    styles = list(col_styles)
    batch = []
    for rs in row_seeds:
        for cs in col_seeds:
            w = w_by_seed[rs].clone()
            w[styles] = w_by_seed[cs][styles]
            batch.append(w)
    imgs = _numpy(synthesize(torch.stack(batch)))
    if path:
        save_image_grid(imgs, path, nrow=len(col_seeds))
    return imgs


def _parse_num_list(spec, default):
    """Reference seed-list syntax (``style_mixing.py:_parse_num_range``):
    comma-separated ints, each item optionally an ``a-b`` inclusive range."""
    if spec is None:
        spec = default
    if isinstance(spec, (list, tuple)):
        return [int(s) for s in spec]
    if isinstance(spec, int):
        return [spec]
    out = []
    for item in str(spec).split(","):
        item = item.strip()
        if "-" in item[1:]:
            a, b = item.rsplit("-", 1)
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(item))
    return out


def _needs_features():
    return ValueError("this model is instance-conditioned: pass stored_features=<kmeans .npy> "
                      "(cli/prepare_data.py kmeans_subsampled writes one)")


def main(argv=None):
    """Sheet generator CLI (reference ``BigGAN_PyTorch/sample.py`` and
    ``stylegan2_ada_pytorch/style_mixing.py``): every sheet kind the flags
    or ``mode`` ask for, written under ``out_dir`` (a numbered subfolder with
    ``sample_sheet_folder_num``).  Returns the paths written.  Runs on CUDA
    unless ``--device`` names another device."""
    import os

    from ic_gan_tpu_torch.cli.config import parse_args
    from ic_gan_tpu_torch.cli.inference import (
        conditioning_flags,
        device_flag,
        latent_dim,
        load_model_inference,
        load_stored_features,
    )

    cfg = parse_args(argv)
    mode = cfg.get("mode")
    modes = [mode] if mode else [
        m for flag, m in (("sample_sheets", "sample_sheet"), ("sample_interps", "interp"),
                          ("sample_random", "random")) if cfg.get(flag)
    ] or ["sample_sheet"]

    apply_fn, model_cfg = load_model_inference(cfg, device=device_flag(argv))
    dim_z = latent_dim(model_cfg)
    z_var = cfg.get("z_var", 1.0)
    seed = cfg.get("seed", 0)
    out_dir = cfg.get("out_dir", "sheets")
    # Reference sheet layout: a numbered subfolder (``sample_sheet_folder_num``,
    # utils.py:1406-1414).
    folder_num = cfg.get("sample_sheet_folder_num", -1)
    if folder_num is not None and int(folder_num) >= 0:
        out_dir = os.path.join(out_dir, str(int(folder_num)))
    os.makedirs(out_dir, exist_ok=True)

    features = labels = None
    if cfg.get("stored_features"):
        features, labels = load_stored_features(cfg["stored_features"])
    class_cond, instance_cond = conditioning_flags(cfg, model_cfg)
    # Label space of either backbone (StyleGAN2 carries c_dim, not n_classes).
    num_classes = getattr(model_cfg, "n_classes", 0) or getattr(model_cfg, "c_dim", 1)
    written = []

    def conditionings(n):
        """(label, feats) pairs: stored instances when given, else classes
        (the reference's per-class sheets, ``utils.py:1402-1460``)."""
        if features is not None:
            return [(labels[i] if labels is not None and class_cond else None, features[i])
                    for i in range(min(n, len(features)))]
        if instance_cond:
            raise _needs_features()
        if class_cond:
            return [(c, None) for c in range(min(n, num_classes))]
        return [(None, None)] * n          # unconditional: fresh-z rows

    for m in modes:
        if m == "sample_sheet":
            path = os.path.join(out_dir, "sample_sheet.png")
            sample_sheet(apply_fn, dim_z, conditionings(cfg.get("num_conditionings_gen", 8)),
                         samples_per_cond=cfg.get("num_imgs_gen", 8), z_var=z_var, seed=seed,
                         path=path)
            written.append(path)
        elif m == "interp":
            # The reference's three variants (sample.py → utils.interp_sheet
            # fix_z/fix_y): interpolate both, z only, the conditioning only.
            variants = [("interp_zfeats", False, False)]
            if features is not None:
                variants += [("interp_z", False, True), ("interp_feats", True, False)]
            labels_bank = None
            if class_cond:
                labels_bank = labels if labels is not None else np.arange(num_classes)
            if features is None and instance_cond:
                raise _needs_features()
            for name, fix_z, fix_feats in variants:
                path = os.path.join(out_dir, f"{name}.png")
                interp_sheet(apply_fn, dim_z, num_midpoints=cfg.get("num_midpoints", 8),
                             num_rows=cfg.get("num_rows", 4), fix_z=fix_z, fix_feats=fix_feats,
                             feats_bank=features, labels_bank=labels_bank, z_var=z_var,
                             seed=seed, path=path)
                written.append(path)
        elif m == "random":
            n = cfg.get("num_samples", 64)
            z = _randn((n, dim_z), torch.Generator().manual_seed(seed)) * math.sqrt(z_var)
            lab = f = None
            if features is not None:
                idx = np.random.RandomState(seed).randint(0, len(features), n)
                f = features[idx]
                if labels is not None and class_cond:
                    lab = np.asarray(labels)[idx]
            elif instance_cond:
                raise _needs_features()
            elif class_cond:
                lab = np.random.RandomState(seed).randint(0, num_classes, n)
            path = os.path.join(out_dir, "random.png")
            save_image_grid(_numpy(apply_fn(z, lab, f)), path, nrow=8)
            written.append(path)
        elif m == "style_mixing":
            if cfg.get("backbone", "biggan") != "stylegan2":
                raise ValueError("style_mixing needs backbone=stylegan2")
            g = apply_fn.module
            device = next(g.parameters()).device
            psi = cfg.get("truncation_psi", 1.0)
            cond = None
            if features is not None and getattr(model_cfg, "h_dim", 0):
                cond = features[cfg.get("input_feature_index", 0)]

            def map_ws(z, f):
                with torch.inference_mode():
                    return g.map_ws(z.to(device), None, None if f is None else f.to(device),
                                    truncation_psi=psi)

            def synthesize(ws):
                with torch.inference_mode():
                    return g.synthesize(ws, noise_mode="const").permute(0, 2, 3, 1)

            path = os.path.join(out_dir, "style_mixing.png")
            style_mixing_grid(
                map_ws, synthesize, model_cfg.z_dim,
                row_seeds=_parse_num_list(cfg.get("row_seeds"), "85,100,75,458"),
                col_seeds=_parse_num_list(cfg.get("col_seeds"), "55,821,1789"),
                col_styles=_parse_num_list(cfg.get("col_styles"), "0-6"),
                cond_feats=cond, truncation_psi=psi, path=path)
            written.append(path)
        else:
            raise ValueError(f"unknown visualize mode {m!r}")

    for p in written:
        print(f"wrote {p}")
    return written


if __name__ == "__main__":
    main()
