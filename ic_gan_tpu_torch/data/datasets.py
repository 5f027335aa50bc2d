"""IC-GAN dataset layer: HDF5-backed images, labels and instance features
with k-NN conditioning sampling.  Port of ``ic_gan_tpu/data/datasets.py``
(reference ``data_utils/datasets_common.py:240-822`` and the factory
``data_utils/utils.py:444-637``).

Host-side numpy, as in the JAX package: an explicit ``np.random.Generator``
(``default_rng(seed)``) makes every draw, in the same order as the JAX class,
so a batch equals its batch draw for draw; neighbour tables are dense (N, k)
arrays and draws are vectorized.  Images leave the host as stored, uint8,
and come out NCHW (the port's layout), float32 in [-1, 1] on the dataset's
device (``data.loader``).

``h5py`` is imported when an ``HDF5Dataset`` is built, never at module
import: a machine without it can still import the package (and train from
an in-memory dataset with the same two sampling methods).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ic_gan_tpu_torch.data.loader import normalize_batch


def hdf5_filenames(
    resolution: int,
    which_dataset: str = "imagenet",
    longtail: bool = False,
    split: str = "train",
    test_part: bool = False,
    feature_extractor: str = "classification",
    backbone: str = "resnet50",
    k_nn: int = 50,
):
    """File-name conventions of the reference (``data_utils/utils.py:538-586``)."""
    if which_dataset in ("imagenet", "imagenet_lt"):
        prefix = "ILSVRC"
    elif which_dataset == "coco":
        prefix = "COCO"
    else:
        prefix = which_dataset
    base = "%s%i%s%s%s" % (
        prefix,
        resolution,
        "longtail" if longtail else "",
        "_val" if split == "val" else "",
        "_test" if test_part else "",
    )
    return {
        "xy": f"{base}_xy.hdf5",
        "feats": f"{base}_feats_{feature_extractor}_{backbone}.hdf5",
        "nns": f"{base}_feats_{feature_extractor}_{backbone}_nn_k{k_nn}.hdf5",
    }


def kmeans_filename(resolution, which_dataset="imagenet",
                    feature_extractor="selfsupervised", k=1000):
    d_name = {"imagenet": "IN", "coco": "COCO"}.get(which_dataset, which_dataset)
    return f"{d_name}_res{resolution}_rn50_{feature_extractor}_kmeans_k{k}.npy"


@dataclasses.dataclass
class Batch:
    """One training batch (NCHW, normalized); the images on the dataset's
    device (``data.loader``), the rest host arrays."""

    images: torch.Tensor               # (B, 3, H, W) float32 in [-1, 1]
    labels: Optional[np.ndarray]       # (B,) int64 or (B, label_dim) one-hot
    features: Optional[np.ndarray]     # (B, F) float32, L2-normalized
    radii: Optional[np.ndarray]        # (B,) float32


class HDF5Dataset:
    """HDF5 dataset with instance-feature conditioning.

    Mirrors ``ILSVRC_HDF5_feats``: ``root`` holds ``imgs`` (N,3,H,W uint8) and
    ``labels``; ``root_feats`` holds ``feats`` (+ optional ``feats_hflip``);
    ``root_nns`` holds ``sample_nns`` [N,k] and ``sample_nns_radius`` [N].
    Training batches are normalized on ``device`` (CUDA unless named) by
    ``data.loader.normalize_batch``; without ``root_nns`` the k-NN table is
    computed in process there too.
    """

    def __init__(
        self,
        root: str,
        root_feats: Optional[str] = None,
        root_nns: Optional[str] = None,
        load_labels: bool = True,
        load_features: bool = True,
        load_in_mem_images: bool = False,
        load_in_mem_labels: bool = True,
        load_in_mem_feats: bool = True,
        k_nn: int = 50,
        which_nn_balance: str = "instance_balance",
        kmeans_file: Optional[str] = None,
        n_subsampled_data: int = -1,
        allowed_idxs: Optional[np.ndarray] = None,
        label_dim: int = 0,
        feature_dim: int = 2048,
        feature_augmentation: bool = False,
        apply_norm: bool = True,
        label_onehot: bool = False,
        hflip: bool = False,
        seed: int = 0,
        device=None,
    ):
        import h5py

        self._h5 = h5py
        self.root = root
        self.root_feats = root_feats
        self.root_nns = root_nns
        self.load_labels = load_labels
        self.load_features = load_features
        self.label_onehot = label_onehot
        self._label_dim = label_dim
        self._feature_dim = feature_dim
        self.feature_augmentation = feature_augmentation
        self.apply_norm = apply_norm
        self.which_nn_balance = which_nn_balance
        self.hflip = hflip
        self.rng = np.random.default_rng(seed)
        self.device = device

        with h5py.File(root, "r") as f:
            self.total_imgs = len(f["labels"])

        self.data = None
        self.labels = None
        self.feats = None
        if load_in_mem_images:
            with h5py.File(root, "r") as f:
                self.data = f["imgs"][:]
        if load_labels and load_in_mem_labels:
            with h5py.File(root, "r") as f:
                self.labels = f["labels"][:]
        if load_features and load_in_mem_feats and root_feats is not None:
            with h5py.File(root_feats, "r") as f:
                feats = f["feats"][:].astype(np.float32)
                self.feats_hflip = (
                    f["feats_hflip"][:].astype(np.float32)
                    if feature_augmentation and "feats_hflip" in f
                    else None
                )
            self.feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
            if self.feats_hflip is not None:
                self.feats_hflip = self.feats_hflip / np.linalg.norm(
                    self.feats_hflip, axis=1, keepdims=True
                )
        else:
            self.feats_hflip = None

        self.sample_nns = None
        self.sample_nn_radius = None
        if load_features:
            if root_nns is not None:
                with h5py.File(root_nns, "r") as f:
                    self.sample_nns = f["sample_nns"][:]
                    self.sample_nn_radius = f["sample_nns_radius"][:]
            elif self.feats is not None:
                # In process, on the device (faiss replacement; ref
                # datasets_common.py:695-745).
                from ic_gan_tpu_torch.data.feature_bank import knn

                idx, radii = knn(self.feats, k=k_nn + 1, device=device)
                self.sample_nns = idx  # includes self as first neighbour
                self.sample_nn_radius = radii
            else:
                raise ValueError(
                    "Provide root_nns or load features in memory to compute NNs."
                )

        # Subset filtering (ref datasets_common.py:447-470).
        self.kmeans_samples = None
        if kmeans_file is not None:
            self.kmeans_samples = np.load(kmeans_file, allow_pickle=True).item()[
                "center_examples"
            ][:, 0]
            self.possible_sampling_idxs = self.kmeans_samples
        elif n_subsampled_data > -1:
            self.possible_sampling_idxs = self.rng.choice(
                self.total_imgs, int(n_subsampled_data), replace=False
            )
        elif allowed_idxs is not None:
            self.possible_sampling_idxs = np.asarray(allowed_idxs)
        else:
            self.possible_sampling_idxs = np.arange(self.total_imgs)
        self.possible_sampling_idxs = np.asarray(self.possible_sampling_idxs)
        self.num_imgs = len(self.possible_sampling_idxs)

    # -- raw accessors -------------------------------------------------------

    @staticmethod
    def _read_h5_rows(dset, idxs: np.ndarray) -> np.ndarray:
        """Row-gather from an HDF5 dataset by per-index contiguous reads:
        h5py's fancy indexing walks a hyperslab union through its selection
        machinery, far slower for scattered training-batch rows.  Duplicates
        are fine here, unlike fancy selection."""
        out = np.empty((len(idxs),) + dset.shape[1:], dset.dtype)
        for j, i in enumerate(idxs):
            dset.read_direct(out, np.s_[int(i)], np.s_[j])
        return out

    def _get_images(self, idxs: np.ndarray) -> np.ndarray:
        """uint8 (B, C, H, W) rows, as stored."""
        idxs = np.asarray(idxs)
        if self.data is not None:
            return self.data[idxs]
        with self._h5.File(self.root, "r") as f:
            return self._read_h5_rows(f["imgs"], idxs)

    def get_label(self, idxs):
        if not self.load_labels:
            return np.zeros(len(np.atleast_1d(idxs)), np.int64)
        if self.labels is not None:
            lab = self.labels[np.asarray(idxs)]
        else:
            with self._h5.File(self.root, "r") as f:
                uniq, inv = np.unique(np.asarray(idxs), return_inverse=True)
                lab = f["labels"][uniq][inv]
        return np.asarray(lab).astype(np.int64).reshape(-1)

    def get_instance_features(self, idxs) -> np.ndarray:
        """L2-normalized features; 50% hflip-feature augmentation per sample
        when enabled (ref ``datasets_common.py:655-678``)."""
        idxs = np.asarray(idxs).reshape(-1)
        if not self.load_features:
            return np.zeros((len(idxs), self._feature_dim), np.float32)
        if self.feats is not None:
            feats = self.feats[idxs]
            hflip_bank = self.feats_hflip
            hflip = None if hflip_bank is None else hflip_bank[idxs]
        else:
            # load_in_mem_feats=False: row-gather from the feature hdf5; the
            # in-memory path normalizes at load, so normalize here.
            with self._h5.File(self.root_feats, "r") as f:
                feats = self._read_h5_rows(f["feats"], idxs)
                hflip = (self._read_h5_rows(f["feats_hflip"], idxs)
                         if self.feature_augmentation and "feats_hflip" in f
                         else None)
            feats = feats / np.maximum(
                np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
            if hflip is not None:
                hflip = hflip / np.maximum(
                    np.linalg.norm(hflip, axis=1, keepdims=True), 1e-12)
        if self.feature_augmentation and hflip is not None:
            flip = self.rng.integers(0, 2, size=len(idxs)).astype(bool)
            feats = np.where(flip[:, None], hflip, feats)
        return feats.astype(np.float32)

    def _one_hot(self, labels):
        out = np.zeros((len(labels), self._label_dim), np.float32)
        out[np.arange(len(labels)), labels] = 1.0
        return out

    # -- training batches ----------------------------------------------------

    def sample_batch(self, batch_size: int, weights=None) -> Batch:
        """Draw a full training batch: per sample, a conditioning instance and
        one of its neighbours (image+label from neighbour, features from the
        instance) — vectorized ``__getitem__`` (ref ``:476-523, 780-819``)."""
        if weights is None:
            sel = self.rng.integers(0, self.num_imgs, size=batch_size)
            idxs = self.possible_sampling_idxs[sel]
        else:
            idxs = self.rng.choice(
                self.possible_sampling_idxs, batch_size, replace=True,
                p=np.asarray(weights) / np.sum(weights),
            )
        if not self.load_features:
            hflip_mask = (
                self.rng.integers(0, 2, size=batch_size).astype(np.uint8)
                if self.hflip else None
            )
            imgs = self._prepare_images(idxs, hflip_mask)
            labels = self.get_label(idxs) if self.load_labels else None
            return Batch(imgs, self._maybe_onehot(labels), None, None)

        if self.which_nn_balance == "instance_balance":
            idx_h = idxs
            if self.kmeans_samples is not None:
                idxs = self.rng.choice(self.kmeans_samples, size=batch_size)
            nn_rows = self.sample_nns[idxs]
            idx_nn = nn_rows[
                np.arange(batch_size),
                self.rng.integers(0, nn_rows.shape[1], size=batch_size),
            ]
        else:  # nnclass_balance
            nn_rows = self.sample_nns[idxs]
            idx_h = nn_rows[
                np.arange(batch_size),
                self.rng.integers(0, nn_rows.shape[1], size=batch_size),
            ]
            idx_nn = idxs

        radii = self.sample_nn_radius[idx_h].astype(np.float32)
        hflip_mask = (
            self.rng.integers(0, 2, size=batch_size).astype(np.uint8)
            if self.hflip else None
        )
        imgs = self._prepare_images(idx_nn, hflip_mask)
        labels = self.get_label(idx_nn) if self.load_labels else None
        feats = self.get_instance_features(idx_h)
        return Batch(imgs, self._maybe_onehot(labels), feats, radii)

    # -- generator conditioning sampling ------------------------------------

    def sample_conditioning_instance_balance(self, batch_size: int, weights=None):
        """(ref ``datasets_common.py:525-576``)."""
        if weights is None:
            sel = self.rng.integers(0, self.num_imgs, size=batch_size)
            sel_idxs = self.possible_sampling_idxs[sel]
        else:
            sel_idxs = self.rng.choice(
                self.possible_sampling_idxs, batch_size, replace=True,
                p=np.asarray(weights) / np.sum(weights),
            )
        instance_gen = self.get_instance_features(sel_idxs)
        labels_gen = None
        if self.load_labels:
            nn_rows = self.sample_nns[sel_idxs]
            chosen = nn_rows[
                np.arange(batch_size),
                self.rng.integers(0, nn_rows.shape[1], size=batch_size),
            ]
            labels_gen = self._maybe_onehot(self.get_label(chosen))
        return labels_gen, instance_gen

    def _class_index_table(self, num_classes: int):
        """Per-class index ranges, computed once: a stable argsort of the
        labels plus [start, end) offsets per class, instead of a scan of the
        whole label array per draw."""
        cache = getattr(self, "_class_idx_cache", None)
        if cache is not None and cache[0] == num_classes:
            return cache[1:]
        labels = (
            self.labels.reshape(-1)
            if self.labels is not None
            else self.get_label(np.arange(self.total_imgs))
        )
        order = np.argsort(labels, kind="stable").astype(np.int64)
        sorted_labels = labels[order]
        classes = np.arange(num_classes)
        starts = np.searchsorted(sorted_labels, classes, "left")
        ends = np.searchsorted(sorted_labels, classes, "right")
        self._class_idx_cache = (num_classes, order, starts, ends)
        return order, starts, ends

    def sample_conditioning_nnclass_balance(
        self, batch_size: int, weights=None, num_classes: int = 1000
    ):
        """(ref ``datasets_common.py:578-622``), vectorized: one categorical
        class draw, one uniform member pick through the per-class index
        table, one gather into the dense [N, k] neighbour matrix."""
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            weights = weights / weights.sum()
        chosen_class = self.rng.choice(
            num_classes, batch_size, replace=True, p=weights
        )
        order, starts, ends = self._class_index_table(num_classes)
        counts = ends[chosen_class] - starts[chosen_class]
        if (counts <= 0).any():
            bad = chosen_class[counts <= 0][0]
            raise ValueError(f"no samples available for class {bad}")
        offsets = self.rng.integers(0, counts)
        chosen_xnn = order[starts[chosen_class] + offsets]
        nn_cols = self.rng.integers(0, self.sample_nns.shape[1], batch_size)
        nn_idxs = self.sample_nns[chosen_xnn, nn_cols].astype(np.int64)
        instance_gen = self.get_instance_features(nn_idxs)
        return self._maybe_onehot(chosen_class.astype(np.int64)), instance_gen

    # -- helpers -------------------------------------------------------------

    def _norm(self, imgs_u8: np.ndarray) -> np.ndarray:
        """uint8 → float32 in [-1, 1] by the JAX package's formula,
        (x/255 − 0.5)·2, on the host; the eval reads real images by it
        through ``data.loader``'s ``"norm"`` table (``_prepare_images``
        rounds as the native loader does, which can differ from this in the
        last bit)."""
        imgs = imgs_u8.astype(np.float32)
        if self.apply_norm:
            imgs = (imgs / 255.0 - 0.5) * 2.0
        return imgs

    def _prepare_images(self, idxs: np.ndarray, hflip_mask=None) -> torch.Tensor:
        """uint8 (B, C, H, W) rows → float32 (B, C, H, W) on the device,
        flipped along W where ``hflip_mask`` is set, mapped to [-1, 1] by
        x·(2/255) − 1 (the JAX package's native loader's arithmetic, bit for
        bit: ``data.loader``)."""
        return normalize_batch(self._get_images(idxs), hflip_mask, self.apply_norm,
                               device=self.device)

    def _maybe_onehot(self, labels):
        if labels is None:
            return None
        if self.label_onehot:
            return self._one_hot(labels)
        return labels

    def __len__(self):
        return self.num_imgs

    @property
    def resolution(self):
        with self._h5.File(self.root, "r") as f:
            return f["imgs"][0].shape[1]

    @property
    def feature_dim(self):
        return self._feature_dim


def get_dataset_hdf5(
    resolution: int,
    data_path: str,
    which_dataset: str = "imagenet",
    longtail: bool = False,
    split: str = "train",
    test_part: bool = False,
    class_cond: bool = True,
    instance_cond: bool = True,
    feature_extractor: str = "selfsupervised",
    backbone_feature_extractor: str = "resnet50",
    which_nn_balance: str = "instance_balance",
    kmeans_subsampled: int = -1,
    n_subsampled_data: int = -1,
    feature_augmentation: bool = False,
    k_nn: int = 50,
    hflip: bool = False,
    load_in_mem_feats: bool = True,
    compute_nns: bool = False,
    seed: int = 0,
    filter_hd: int = -1,
    xy_filename: Optional[str] = None,
    feats_filename: Optional[str] = None,
    nns_filename: Optional[str] = None,
    **dataset_kwargs,
) -> HDF5Dataset:
    """Factory with the reference's file-name conventions
    (``data_utils/utils.py:444-637``).  Explicit ``*_filename`` overrides
    bypass the conventions (the StyleGAN2 JSONs name their hdf5 files
    directly: ``data`` / ``root_feats`` / ``root_nns``, ref train.py:144-167).
    ``dataset_kwargs`` go to ``HDF5Dataset`` (``device`` among them)."""
    names = hdf5_filenames(
        resolution, which_dataset, longtail, split, test_part,
        feature_extractor, backbone_feature_extractor, k_nn,
    )
    if xy_filename:
        names["xy"] = xy_filename
    if feats_filename:
        names["feats"] = feats_filename
    if nns_filename:
        names["nns"] = nns_filename
    kmeans_file = None
    if kmeans_subsampled > -1:
        kmeans_file = os.path.join(
            data_path,
            kmeans_filename(resolution, which_dataset, feature_extractor,
                            kmeans_subsampled),
        )
    if filter_hd > -1:
        # COCO-Stuff eval-set hamming filter (ref utils.py:640-680; the index
        # files live under <data>/coco_stuff_val_indexes/).
        from ic_gan_tpu_torch.data.image_datasets import filter_by_hd

        idx_dir = os.path.join(data_path, "coco_stuff_val_indexes")
        dataset_kwargs["allowed_idxs"] = filter_by_hd(
            filter_hd,
            os.path.join(idx_dir, "cocostuff_val2_all_idxs.npy"),
            os.path.join(idx_dir, "val2_image_ids_by_hd_75ktraining_im.npy"),
        )
    return HDF5Dataset(
        root=os.path.join(data_path, names["xy"]),
        root_feats=os.path.join(data_path, names["feats"]) if instance_cond else None,
        root_nns=(
            os.path.join(data_path, names["nns"])
            if instance_cond and not compute_nns
            else None
        ),
        load_labels=class_cond,
        load_features=instance_cond,
        k_nn=k_nn,
        which_nn_balance=which_nn_balance,
        kmeans_file=kmeans_file,
        n_subsampled_data=n_subsampled_data,
        feature_augmentation=feature_augmentation,
        load_in_mem_feats=load_in_mem_feats,
        hflip=hflip,
        seed=seed,
        **dataset_kwargs,
    )
