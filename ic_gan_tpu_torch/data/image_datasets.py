"""Raw image datasets: ImageNet-layout folders (+ ImageNet-LT txt splits) and
COCO-Stuff with annotation filtering, and the COCO-Stuff hamming-distance
filter.  Port of ``ic_gan_tpu/data/image_datasets.py``.

Reference: ``data_utils/datasets_common.py:103-237`` (ImageFolder with LT
split loading) and ``data_utils/cocostuff_dataset.py:53-281`` (COCO+Stuff
JSON loader with object-count/size filters and train/val/"test_part"
splits).  Numpy batches ``(NHWC float [-1, 1], label, index)``, PIL
decoding, explicit rng, as in the JAX package; only the class-set distance
product of ``build_hd_indexes`` runs on a device.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device


def filter_by_hd(
    ood_distance: int,
    all_idxs_file: str,
    ids_by_hd_file: str,
) -> np.ndarray:
    """COCO-Stuff evaluation-set filter by hamming distance of class sets
    (ref ``data_utils/utils.py:640-680``): distance 0 keeps only images whose
    class combination was seen in training; >0 keeps all unseen combinations.

    The two npy files are the reference's precomputed artifacts
    (``cocostuff_val_indexes/cocostuff_val2_all_idxs.npy`` and
    ``val2_image_ids_by_hd_75ktraining_im.npy``), or ``build_hd_indexes``'.
    """
    image_ids_original = np.load(all_idxs_file, allow_pickle=True)
    by_hd = np.load(ids_by_hd_file, allow_pickle=True)
    if ood_distance == 0:
        image_ids = set(by_hd[0])
    else:
        image_ids = set()
        for dist in range(1, len(by_hd)):
            image_ids.update(by_hd[dist])
    return np.asarray(
        [i for i, img_id in enumerate(image_ids_original) if img_id in image_ids]
    )


def build_hd_indexes(
    eval_ids,
    eval_class_sets,
    train_class_sets,
    out_dir: str,
    prefix: str = "val2",
    suffix: str = "_75ktraining_im",
    device=None,
):
    """Build the COCO-Stuff hamming-distance index npys that
    ``filter_by_hd`` consumes (the reference ships them as precomputed blobs,
    read at ``utils.py:656-664``, with no in-tree builder).

    For every evaluation image, the minimum hamming distance between its set
    of present classes and every training image's is one product of the
    class-presence bit matrices on ``device`` (CUDA unless named):
    |a Δ b| = |a| + |b| − 2·a·b, exact in float32 (0/1 entries, integer sums
    far below 2^24).  Images are bucketed by that distance: ``by_hd[d]`` =
    eval image ids at minimum distance d.

    eval_ids: sequence of eval image ids (dataset order);
    eval_class_sets / train_class_sets: per-image iterables of class ids.
    Writes ``cocostuff_{prefix}_all_idxs.npy`` and
    ``{prefix}_image_ids_by_hd{suffix}.npy``; returns (all_idxs, by_hd).
    """
    device = resolve_device(device)
    vocab = sorted(
        set().union(*map(set, list(eval_class_sets) + list(train_class_sets)))
    )
    col = {c: i for i, c in enumerate(vocab)}

    def bitmat(sets):
        m = np.zeros((len(sets), len(vocab)), np.float32)
        for r, s in enumerate(sets):
            for c in set(s):
                m[r, col[c]] = 1.0
        return torch.as_tensor(m, device=device)

    a = bitmat(list(eval_class_sets))
    b = bitmat(list(train_class_sets))
    hd = a.sum(1, keepdim=True) + b.sum(1)[None, :] - 2.0 * (a @ b.T)
    hd_min = hd.min(dim=1).values.cpu().numpy().astype(np.int64)

    by_hd = [
        [eval_ids[i] for i in np.nonzero(hd_min == d)[0]]
        for d in range(int(hd_min.max()) + 1)
    ]
    all_idxs = np.asarray(list(eval_ids))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"cocostuff_{prefix}_all_idxs.npy"), all_idxs)
    np.save(
        os.path.join(out_dir, f"{prefix}_image_ids_by_hd{suffix}.npy"),
        np.asarray(by_hd, dtype=object),
        allow_pickle=True,
    )
    return all_idxs, by_hd


def coco_class_sets(ds):
    """Per-image sets of category ids present, in ``ds.image_ids`` order
    (input to ``build_hd_indexes``)."""
    return [
        {obj["category_id"] for obj in ds.id_to_objects[img_id]}
        for img_id in ds.image_ids
    ]


def _center_crop_resize(img, resolution: int):
    """A PIL image's centered square crop of its short side, resized to
    ``resolution``² bilinearly (ref ``generate_images.py:198-210``)."""
    from PIL import Image

    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    return img.resize((resolution, resolution), Image.BILINEAR)


class ImageFolderDataset:
    """Directory-walk dataset (ImageNet layout) with optional ImageNet-LT
    txt-file splits (ref ``datasets_common.py:103-237``).

    Returns ``(image NHWC float [-1,1], label, index)`` triples in batches.
    """

    def __init__(
        self,
        root: str,
        resolution: int = 64,
        longtail: bool = False,
        split_file: Optional[str] = None,
        apply_norm: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.resolution = resolution
        self.apply_norm = apply_norm
        self.rng = np.random.default_rng(seed)
        if longtail and split_file:
            # ImageNet-LT txt: "<relpath> <label>" per line
            # (ref :159-172, BigGAN_PyTorch/imagenet_lt/ImageNet_LT_train.txt).
            self.samples = []
            with open(split_file) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        self.samples.append((parts[0], int(parts[1])))
        else:
            classes = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )
            class_to_idx = {c: i for i, c in enumerate(classes)}
            self.samples = []
            for c in classes:
                cdir = os.path.join(root, c)
                for fname in sorted(os.listdir(cdir)):
                    if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                        self.samples.append(
                            (os.path.join(c, fname), class_to_idx[c])
                        )
        self.labels = np.asarray([s[1] for s in self.samples], np.int64)

    def __len__(self):
        return len(self.samples)

    def get_images(self, idxs: Sequence[int]) -> np.ndarray:
        from PIL import Image

        out = np.empty(
            (len(idxs), self.resolution, self.resolution, 3), np.float32
        )
        for i, idx in enumerate(idxs):
            path, _ = self.samples[idx]
            img = Image.open(os.path.join(self.root, path)).convert("RGB")
            out[i] = np.asarray(_center_crop_resize(img, self.resolution), np.float32)
        if self.apply_norm:
            out = (out / 255.0 - 0.5) * 2.0
        return out

    def batch(self, idxs):
        idxs = np.asarray(idxs)
        return self.get_images(idxs), self.labels[idxs], idxs


class CocoStuffDataset:
    """COCO + COCO-Stuff annotation loader with the reference's filters
    (object count in [min, max], bbox area > min_object_size, 'other'
    category excluded, crowd filtering, stuff_only intersection, val split
    = first 1024 / test_part = rest; ref ``cocostuff_dataset.py:90-204``)."""

    def __init__(
        self,
        image_dir: str,
        instances_json: str,
        stuff_json: Optional[str] = None,
        stuff_only: bool = True,
        resolution: int = 64,
        min_object_size: float = 0.02,
        min_objects_per_image: int = 3,
        max_objects_per_image: int = 8,
        instance_whitelist: Optional[List[str]] = None,
        stuff_whitelist: Optional[List[str]] = None,
        iscrowd: bool = True,
        split: str = "train",
        test_part: bool = False,
        apply_norm: bool = True,
    ):
        self.image_dir = image_dir
        self.resolution = resolution
        self.apply_norm = apply_norm
        self.flip_augment = split == "train"

        with open(instances_json) as f:
            instances_data = json.load(f)
        stuff_data = None
        if stuff_json:
            with open(stuff_json) as f:
                stuff_data = json.load(f)

        self.image_ids = []
        self.id_to_filename = {}
        self.id_to_size = {}
        for im in instances_data["images"]:
            self.image_ids.append(im["id"])
            self.id_to_filename[im["id"]] = im["file_name"]
            self.id_to_size[im["id"]] = (im["width"], im["height"])

        idx_to_name = {}
        all_instance_cats = self._populate(instances_data, idx_to_name)
        all_stuff_cats = self._populate(stuff_data, idx_to_name)
        whitelist = set(instance_whitelist or all_instance_cats) | set(
            stuff_whitelist or all_stuff_cats
        )

        self.id_to_objects = defaultdict(list)
        self._add_objects(instances_data, min_object_size, idx_to_name,
                          whitelist, iscrowd)
        with_stuff = self._add_objects(stuff_data, min_object_size,
                                       idx_to_name, whitelist, iscrowd)
        if stuff_only and stuff_data is not None:
            self.image_ids = [i for i in self.image_ids if i in with_stuff]

        self.image_ids = [
            i for i in self.image_ids
            if min_objects_per_image
            <= len(self.id_to_objects[i])
            <= max_objects_per_image
        ]
        if split == "val":
            self.image_ids = (
                self.image_ids[1024:] if test_part else self.image_ids[:1024]
            )
        self.labels = np.zeros(len(self.image_ids), np.int64)  # void labels

    @staticmethod
    def _populate(data, idx_to_name):
        cats = []
        if data is None:
            return cats
        for c in data["categories"]:
            cats.append(c["name"])
            idx_to_name[c["id"]] = c["name"]
        return cats

    def _add_objects(self, data, min_size, idx_to_name, whitelist, iscrowd):
        present = set()
        if data is None:
            return present
        for obj in data["annotations"]:
            image_id = obj["image_id"]
            _, _, w, h = obj["bbox"]
            present.add(image_id)
            W, H = self.id_to_size[image_id]
            name = idx_to_name[obj["category_id"]]
            ok = (
                (w * h) / (W * H) > min_size
                and name in whitelist
                and name != "other"
            )
            if iscrowd:
                ok = ok and obj.get("iscrowd", 0) != 1
            if ok:
                self.id_to_objects[image_id].append(obj)
        return present

    def __len__(self):
        return len(self.image_ids)

    def get_images(self, idxs, flip: Optional[np.ndarray] = None):
        from PIL import Image, ImageOps

        out = np.empty(
            (len(idxs), self.resolution, self.resolution, 3), np.float32
        )
        for i, idx in enumerate(idxs):
            path = os.path.join(
                self.image_dir, self.id_to_filename[self.image_ids[idx]]
            )
            img = Image.open(path).convert("RGB")
            if flip is not None and flip[i]:
                img = ImageOps.mirror(img)
            out[i] = np.asarray(
                _center_crop_resize(img, self.resolution), np.float32
            )
        if self.apply_norm:
            out = (out / 255.0 - 0.5) * 2.0
        return out

    def batch(self, idxs):
        idxs = np.asarray(idxs)
        return self.get_images(idxs), self.labels[idxs], idxs
