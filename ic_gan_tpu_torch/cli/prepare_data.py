"""Data preparation: build the HDF5s, feature banks, k-NN tables, reference
moments and k-means instance selections.  Port of
``ic_gan_tpu/cli/prepare_data.py`` (reference ``data_utils/prepare_data.sh``
+ ``make_hdf5.py`` + ``make_hdf5_nns.py`` + ``store_kmeans_indexes.py`` +
``calculate_inception_moments.py``, unified in one CLI):

    python -m ic_gan_tpu_torch.cli.prepare_data --set image_root=... \\
        out_path=... resolution=64 which_dataset=imagenet \\
        feature_extractor=selfsupervised [--device cuda]

Feature extraction runs the port's ResNet-50 on the device (224² bicubic,
ref ``make_hdf5.py:232-243``); the k-NN table and k-means run there as
brute-force matmuls (``data/feature_bank.py``).  Each stage is an
array-level core (``iter_features``, ``nns_of``, ``kmeans_selection``) and
a file wrapper with the JAX package's signature, which adds the HDF5 or npy
file (``h5py`` is imported by the wrappers only).  Runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.cli.config import parse_args
from ic_gan_tpu_torch.data.datasets import hdf5_filenames, kmeans_filename


def iter_image_folder(root: str, resolution: int, batch: int = 256):
    """Walk an ImageNet-layout directory (class subdirs) and yield
    ``(uint8 CHW images, labels)`` batches at the target resolution
    (center-crop + resize, ref ``make_hdf5.py`` CenterCropLongEdge)."""
    from PIL import Image

    from ic_gan_tpu_torch.data.image_datasets import _center_crop_resize

    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    imgs, labels = [], []
    for label, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            img = Image.open(os.path.join(cdir, fname)).convert("RGB")
            img = _center_crop_resize(img, resolution)
            imgs.append(np.transpose(np.asarray(img, np.uint8), (2, 0, 1)))
            labels.append(label)
            if len(imgs) == batch:
                yield np.stack(imgs), np.asarray(labels, np.int64)
                imgs, labels = [], []
    if imgs:
        yield np.stack(imgs), np.asarray(labels, np.int64)


def build_xy_hdf5(image_iter, out_path: str, chunk: int = 500):
    """Stream images/labels into ``*_xy.hdf5`` (uint8 CHW + int64, chunks of
    at most 500 rows; ref ``make_hdf5.py:254-330``).  Written to a temporary
    file and renamed, so that an interrupted run leaves no truncated file
    that a later run would take for a finished one.  Returns the row
    count."""
    import h5py

    tmp_path = out_path + ".tmp"
    with h5py.File(tmp_path, "w") as f:
        imgs_ds = labels_ds = None
        n = 0
        for imgs, labels in image_iter:
            if imgs_ds is None:
                shape = imgs.shape[1:]
                imgs_ds = f.create_dataset(
                    "imgs", (0,) + shape, maxshape=(None,) + shape,
                    dtype=np.uint8, chunks=(min(chunk, 500),) + shape,
                )
                labels_ds = f.create_dataset(
                    "labels", (0,), maxshape=(None,), dtype=np.int64,
                    chunks=(min(chunk, 500),),
                )
            imgs_ds.resize(n + len(imgs), 0)
            labels_ds.resize(n + len(imgs), 0)
            imgs_ds[n:] = imgs
            labels_ds[n:] = labels
            n += len(imgs)
    os.replace(tmp_path, out_path)
    return n


def load_feature_extractor(weights_path: Optional[str] = None, device=None):
    """The ResNet-50 trunk on ``device`` (CUDA unless named) from a
    torchvision or SwAV ``.pth`` (a state dict, or one under
    ``"state_dict"``; ``models.resnet.load_torch_resnet50``); without a file,
    random weights drawn on the CPU from a generator seeded 0, with a
    warning (for pipeline tests only)."""
    from ic_gan_tpu_torch.models.resnet import ResNet50, load_torch_resnet50

    device = resolve_device(device)
    if weights_path and os.path.exists(weights_path):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        return load_torch_resnet50(sd.get("state_dict", sd), device=device)
    warnings.warn("no feature-extractor weights; using random init (pipeline test only)",
                  stacklevel=2)
    return ResNet50(device="cpu", generator=torch.Generator().manual_seed(0)).to(device)


def iter_features(imgs, net, batch: int = 128, hflip_bank: bool = True
                  ) -> Iterator[Tuple[int, int, np.ndarray, Optional[np.ndarray]]]:
    """ResNet-50 pooled features of uint8 (N, 3, H, W) images at 224²
    bicubic (``models.resnet.preprocess``), and with ``hflip_bank`` those of
    the images flipped along W (the feature-augmentation bank; ref
    ``make_hdf5.py:232-330``), in batches of ``batch`` on ``net``'s device.
    ``imgs`` is anything sliced by rows (an array, an HDF5 dataset).  Yields
    ``(lo, hi, feats (hi-lo, 2048), feats_hflip or None)``, float32 numpy."""
    from ic_gan_tpu_torch.models.resnet import preprocess

    device = next(net.parameters()).device
    with torch.inference_mode():
        for lo in range(0, len(imgs), batch):
            hi = min(lo + batch, len(imgs))
            x = torch.as_tensor(np.asarray(imgs[lo:hi]), device=device).float() / 255.0
            feats = net(preprocess(x))[0].cpu().numpy()
            flipped = net(preprocess(x.flip(3)))[0].cpu().numpy() if hflip_bank else None
            yield lo, hi, feats, flipped


def extract_features(
    xy_path: str,
    out_path: str,
    weights_path: Optional[str] = None,
    batch: int = 128,
    hflip_bank: bool = True,
    device=None,
):
    """The feature file of an ``*_xy.hdf5``: ``feats`` (N, 2048) float32 and
    with ``hflip_bank`` ``feats_hflip`` (``iter_features``), written to a
    temporary file and renamed."""
    import h5py

    net = load_feature_extractor(weights_path, device)
    tmp_path = out_path + ".tmp"
    with h5py.File(xy_path, "r") as fin, h5py.File(tmp_path, "w") as fout:
        n = len(fin["labels"])
        feats_ds = fout.create_dataset("feats", (n, 2048), dtype=np.float32)
        hflip_ds = (
            fout.create_dataset("feats_hflip", (n, 2048), dtype=np.float32)
            if hflip_bank else None
        )
        for lo, hi, feats, flipped in iter_features(fin["imgs"], net, batch, hflip_bank):
            feats_ds[lo:hi] = feats
            if hflip_ds is not None:
                hflip_ds[lo:hi] = flipped
    os.replace(tmp_path, out_path)
    return out_path


def nns_of(feats, k_nn: int = 50, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The k-NN table of a feature bank: each row L2-normalized, then its
    ``k_nn`` + 1 nearest rows (itself first) and the radius to the last
    (``data.feature_bank.knn``; faiss replacement, ref
    ``make_hdf5_nns.py:97-172``)."""
    from ic_gan_tpu_torch.data.feature_bank import knn

    feats = np.asarray(feats, np.float32)
    feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    return knn(feats, k=k_nn + 1, device=device)


def build_nns(feats_path: str, out_path: str, k_nn: int = 50, device=None):
    """``nns_of`` the ``feats`` of a feature file, written as
    ``sample_nns`` and ``sample_nns_radius`` (temporary file, renamed)."""
    import h5py

    with h5py.File(feats_path, "r") as f:
        feats = f["feats"][:].astype(np.float32)
    idx, radii = nns_of(feats, k_nn, device)
    tmp_path = out_path + ".tmp"
    with h5py.File(tmp_path, "w") as f:
        f.create_dataset("sample_nns", data=idx)
        f.create_dataset("sample_nns_radius", data=radii)
    os.replace(tmp_path, out_path)
    return out_path


def kmeans_selection(feats, num_clusters: int = 1000, num_iters: int = 100, seed: int = 0,
                     device=None) -> np.ndarray:
    """The k-means instance selection (ref ``store_kmeans_indexes.py``):
    ``num_iters`` Lloyd iterations to ``num_clusters`` centroids, then the
    index of the real row closest to each, (K,) int64."""
    from ic_gan_tpu_torch.data.feature_bank import closest_real_to_centroids, kmeans

    centroids, _ = kmeans(feats, num_clusters=num_clusters, num_iters=num_iters, seed=seed,
                          device=device)
    return closest_real_to_centroids(feats, centroids, device=device)


def build_kmeans(feats_path: str, out_path: str, num_clusters: int = 1000,
                 num_iters: int = 100, seed: int = 0, device=None):
    """``kmeans_selection`` of a feature file's ``feats``, saved as the
    reference's ``{"center_examples": (K, 1)}`` npy."""
    import h5py

    with h5py.File(feats_path, "r") as f:
        feats = f["feats"][:].astype(np.float32)
    centers = kmeans_selection(feats, num_clusters, num_iters, seed, device)
    np.save(out_path, {"center_examples": centers[:, None]}, allow_pickle=True)
    return out_path


def main(argv=None):
    from ic_gan_tpu_torch.cli.inference import device_flag

    cfg = parse_args(argv)
    device = resolve_device(device_flag(argv))
    res = cfg.get("resolution", 64)
    which = cfg.get("which_dataset", "imagenet")
    extractor = cfg.get("feature_extractor", "selfsupervised")
    out_dir = cfg.get("out_path", cfg.get("data_root", "data"))
    os.makedirs(out_dir, exist_ok=True)
    names = hdf5_filenames(
        res, which,
        longtail=cfg.get("longtail", False),
        split=cfg.get("split", "train"),
        feature_extractor=extractor,
        k_nn=cfg.get("k_nn", 50),
    )
    xy = os.path.join(out_dir, names["xy"])
    if not os.path.exists(xy):
        # Archive sources (zip / CIFAR tarball / MNIST idx-gz / LSUN lmdb)
        # dispatch like the reference dataset tool; a plain directory means
        # the labeled ImageNet-layout folder walker.
        from ic_gan_tpu_torch.data.archive_readers import as_chw_batches, open_source

        src = cfg["image_root"]
        reader = open_source(src, max_images=cfg.get("max_images"))
        image_iter = (
            iter_image_folder(src, res) if reader is None
            else as_chw_batches(reader, res)
        )
        n = build_xy_hdf5(image_iter, xy, chunk=cfg.get("chunk_size", 500))
        print(f"wrote {n} images to {xy}")
    feats = os.path.join(out_dir, names["feats"])
    if not os.path.exists(feats):
        extract_features(xy, feats, cfg.get("feature_extractor_weights"),
                         hflip_bank=cfg.get("feature_augmentation", True), device=device)
        print(f"wrote features to {feats}")
    nns = os.path.join(out_dir, names["nns"])
    if not os.path.exists(nns):
        build_nns(feats, nns, k_nn=cfg.get("k_nn", 50), device=device)
        print(f"wrote k-NN table to {nns}")
    if cfg.get("kmeans_subsampled", -1) > 0:
        km = os.path.join(out_dir, kmeans_filename(res, which, extractor,
                                                   cfg["kmeans_subsampled"]))
        if not os.path.exists(km):
            build_kmeans(feats, km, num_clusters=cfg["kmeans_subsampled"], device=device)
            print(f"wrote k-means selection to {km}")
    # Reference inception moments for FID.
    if cfg.get("compute_moments", True):
        from ic_gan_tpu_torch.data.datasets import HDF5Dataset
        from ic_gan_tpu_torch.eval.pipeline import (
            InceptionEvaluator,
            compute_dataset_moments,
            moments_filename,
            save_moments,
        )

        ds = HDF5Dataset(root=xy, load_labels=True, load_features=False, device=device)
        ev = InceptionEvaluator(cfg.get("inception_weights"), device=device)
        mu, sigma, _ = compute_dataset_moments(ds, ev)[""]
        save_moments(out_dir, moments_filename(res, which, cfg.get("longtail", False),
                                               cfg.get("split", "train")), mu, sigma)
        print("wrote inception moments")


if __name__ == "__main__":
    main()
