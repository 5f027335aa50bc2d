"""Qualitative generation from stored instance features: port of
``ic_gan_tpu/cli/generate_images.py`` (reference
``inference/generate_images.py``).

    python -m ic_gan_tpu_torch.cli.generate_images --json_config cfg.json \\
        --set pth_dir=weights/ stored_features=path.npy num_imgs_gen=5 \\
        out_path=out.png [--device cuda]

The generator comes from ``cli.inference.load_model_inference`` (an upstream
``.pth`` bundle, a native checkpoint or a StyleGAN2 pickle).  The stored
features npy may instead be found by the reference's file name
(``generate_images.py:25-37``) under ``root_path`` from ``which_dataset``,
``resolution`` and ``model``.  ``index`` pins every row to one k-means
center; ``visualize_instance_images`` puts the ground-truth instance image
column in front (centre crop, resize, a 20-pixel white gutter;
``generate_images.py:198-215``), each stored ``image_path`` read under
``dataset_path``.  Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import os

import numpy as np

from ic_gan_tpu_torch.cli.config import parse_args
from ic_gan_tpu_torch.cli.inference import (
    conditioning_flags,
    device_flag,
    get_conditionings,
    latent_dim,
    load_model_inference,
    load_stored_instances,
    stored_instances_path,
)


def _load_gt_instances(image_paths, idxs, dataset_path: str, resolution: int):
    """The ground-truth instance images as one (N·res, res, 3) uint8 column
    (ref ``generate_images.py:198-210``)."""
    from PIL import Image

    from ic_gan_tpu_torch.data.image_datasets import _center_crop_resize

    rows = []
    for i in idxs:
        p = image_paths[int(i)]
        if isinstance(p, (list, tuple, np.ndarray)):
            p = np.asarray(p).reshape(-1)[0]
        img = Image.open(os.path.join(dataset_path, str(p))).convert("RGB")
        rows.append(np.asarray(_center_crop_resize(img, resolution), np.uint8))
    return np.concatenate(rows, axis=0)


def to_uint8(images: np.ndarray) -> np.ndarray:
    """NHWC images in [-1, 1] → uint8, as the grid stores them."""
    return np.clip((images + 1) * 127.5, 0, 255).astype(np.uint8)


def main(argv=None):
    cfg = parse_args(argv)
    sample_fn, model_cfg = load_model_inference(cfg, device=device_flag(argv))
    resolution = getattr(model_cfg, "resolution", getattr(model_cfg, "img_resolution", None))
    feats_path = cfg.get("stored_features") or stored_instances_path(
        cfg.get("root_path", "."), cfg.get("which_dataset", "imagenet"), resolution,
        cfg.get("model", "icgan"))
    features, labels, image_paths = load_stored_instances(feats_path)

    num_imgs_gen = cfg.get("num_imgs_gen", 5)
    dim_z = latent_dim(model_cfg)
    z, lab, f, idxs = get_conditionings(
        cfg.get("num_conditionings_gen", 5), num_imgs_gen, features, labels, dim_z,
        z_var=cfg.get("z_var", 1.0), swap_target=cfg.get("swap_target"),
        seed=cfg.get("seed", 0), index=cfg.get("index"))
    class_cond, _ = conditioning_flags(cfg, model_cfg)
    # A model without classes reads no labels (the JAX generator drops them).
    images = to_uint8(sample_fn(z, lab if class_cond else None, f))

    # A row-major grid: one row a conditioning, num_imgs_gen columns
    # (ref generate_images.py:187-196).
    n, h, w, c = images.shape
    rows = images.reshape(len(idxs), num_imgs_gen, h, w, c)
    big_plot = np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)
    if cfg.get("visualize_instance_images", False):
        if image_paths is None:
            raise ValueError("visualize_instance_images needs a stored-features npy with an "
                             "'image_path' entry")
        gt = _load_gt_instances(image_paths, idxs, cfg.get("dataset_path", ""), h)
        gutter = np.full((gt.shape[0], 20, gt.shape[2]), 255, np.uint8)
        big_plot = np.concatenate([gt, gutter, big_plot], axis=1)

    from PIL import Image

    out_path = cfg.get("out_path", "generated.png")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(big_plot).save(out_path)
    print(f"wrote {n} images to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
