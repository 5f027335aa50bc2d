"""COCO-Stuff evaluation tooling: ground-truth JPEG dump and hamming indexes.
Port of ``ic_gan_tpu/cli/store_coco_images.py`` (reference
``data_utils/store_coco_jpeg_images.py`` and the missing producer of the
``coco_stuff_val_indexes/*.npy`` that ``data_utils/utils.py:639-680``
reads).  Two modes:

1. ``mode=store_gt``: dump the evaluation split's ground-truth images from
   the ``COCO{res}[_val][_test]_xy.hdf5`` file as numbered JPEGs (the real
   side of folder-against-folder FID), optionally filtered by class-set
   hamming distance (``filter_hd``: 0 = seen class combinations only, >0 =
   unseen).
2. ``mode=build_hd``: build the hamming-index npys from the COCO annotation
   JSONs: per-image class-presence sets of the training and eval splits, one
   product on the device for all pairwise set distances, eval images
   bucketed by their minimum distance to the training set.

    python -m ic_gan_tpu_torch.cli.store_coco_images --set mode=store_gt \\
        data_root=... resolution=128 split=val out_path=gt_jpegs \\
        filter_hd=0 index_dir=coco_stuff_val_indexes
    python -m ic_gan_tpu_torch.cli.store_coco_images --set mode=build_hd \\
        image_dir_train=... instances_json_train=... stuff_json_train=... \\
        image_dir_eval=... instances_json_eval=... stuff_json_eval=... \\
        index_dir=coco_stuff_val_indexes [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np

from ic_gan_tpu_torch.cli.config import parse_args


def store_gt_images(cfg):
    import h5py
    from PIL import Image

    from ic_gan_tpu_torch.data.image_datasets import filter_by_hd

    res = cfg.get("resolution", 128)
    split = cfg.get("split", "val")
    test_part = split == "val"  # ref store_coco_jpeg_images.py:22
    name = "COCO%i%s%s" % (
        res, "_val" if split == "val" else "", "_test" if test_part else ""
    )
    path = os.path.join(cfg["data_root"], name + "_xy.hdf5")
    with h5py.File(path, "r") as f:
        imgs = f["imgs"][:]

    allowed = None
    if cfg.get("filter_hd", -1) > -1:
        index_dir = cfg["index_dir"]
        allowed = set(filter_by_hd(
            cfg["filter_hd"],
            os.path.join(index_dir, "cocostuff_val2_all_idxs.npy"),
            os.path.join(index_dir, "val2_image_ids_by_hd_75ktraining_im.npy"),
        ).tolist())

    out = cfg.get("out_path", "coco_gt_jpegs")
    os.makedirs(out, exist_ok=True)
    count = 0
    for i, im in enumerate(imgs):
        if allowed is not None and i not in allowed:
            continue
        arr = im if im.shape[-1] == 3 else np.transpose(im, (1, 2, 0))
        Image.fromarray(arr.astype(np.uint8)).save(os.path.join(out, "%06d.jpg" % count))
        count += 1
    print(f"stored {count} ground-truth JPEGs in {out}")
    return count


def build_hd(cfg, device=None):
    from ic_gan_tpu_torch.data.image_datasets import (
        CocoStuffDataset,
        build_hd_indexes,
        coco_class_sets,
    )

    common = dict(resolution=cfg.get("resolution", 128))
    train = CocoStuffDataset(
        image_dir=cfg["image_dir_train"],
        instances_json=cfg["instances_json_train"],
        stuff_json=cfg.get("stuff_json_train"),
        split="train",
        **common,
    )
    ev = CocoStuffDataset(
        image_dir=cfg["image_dir_eval"],
        instances_json=cfg["instances_json_eval"],
        stuff_json=cfg.get("stuff_json_eval"),
        split="val",
        test_part=True,  # 'val2' = the eval partition (ref utils.py:656)
        **common,
    )
    all_idxs, by_hd = build_hd_indexes(
        ev.image_ids, coco_class_sets(ev), coco_class_sets(train),
        cfg.get("index_dir", "coco_stuff_val_indexes"), device=device,
    )
    print(
        f"indexed {len(all_idxs)} eval images over {len(by_hd)} hd buckets "
        f"(seen combinations: {len(by_hd[0])})"
    )
    return all_idxs, by_hd


def main(argv=None):
    from ic_gan_tpu_torch.cli.inference import device_flag

    cfg = parse_args(argv)
    mode = cfg.get("mode", "store_gt")
    if mode == "store_gt":
        return store_gt_images(cfg)
    if mode == "build_hd":
        return build_hd(cfg, device=device_flag(argv))
    raise ValueError(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
