"""Dataset-archive input readers for ``cli.prepare_data``: the port's copy
of ``ic_gan_tpu/data/archive_readers.py`` (numpy and PIL only).

The reference's ``stylegan2_ada_pytorch/dataset_tool.py:69-343`` ingests
five source formats (image folder, image zip, hdf5, LSUN lmdb, CIFAR-10
tarball, MNIST idx-gz); this module provides the same breadth for the
HDF5-building pipeline here.  Each ``open_*`` returns
``(num_images, iterator of dict(img=uint8 HWC/HW array, label=int|None))``
— the reference's reader contract — and ``open_source`` dispatches on the
path exactly like ``open_dataset`` (``dataset_tool.py:321-343``).

``num_images`` is an UPPER BOUND, not a guarantee: the LSUN-lmdb reader
(like the reference's) skips undecodable values mid-stream, so its iterator
may yield fewer rows than ``num_images``.  Consumers must treat the count as
advisory — size containers from the rows actually received (as
``as_chw_batches`` does), never pre-allocate-and-wait on the count.

LSUN lmdb runs through the pure-Python ``io.lmdb_reader`` (no ``lmdb`` C
extension in this environment); image bytes decode via PIL with a cv2
fallback mirroring the reference's cv2-then-PIL order.
"""

from __future__ import annotations

import gzip
import io as _io
import json
import os
import pickle
import tarfile
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def _maybe_min(a: int, max_images: Optional[int]) -> int:
    return min(a, max_images) if max_images is not None else a


def open_image_zip(source: str, max_images: Optional[int] = None):
    """Zip archive of images + optional ``dataset.json`` labels
    (ref ``dataset_tool.py:104-130``)."""
    from PIL import Image

    with zipfile.ZipFile(source, mode="r") as z:
        names = [n for n in sorted(z.namelist())
                 if n.lower().endswith(_IMAGE_EXTS)]
        labels = {}
        if "dataset.json" in z.namelist():
            with z.open("dataset.json", "r") as f:
                raw = json.load(f)["labels"]
            labels = {x[0]: x[1] for x in raw} if raw else {}
    n = _maybe_min(len(names), max_images)

    def it():
        with zipfile.ZipFile(source, mode="r") as z:
            for i, name in enumerate(names[:n]):
                with z.open(name, "r") as f:
                    img = np.array(Image.open(f).convert("RGB"))
                yield dict(img=img, label=labels.get(name))

    return n, it()


def open_cifar10(tarball: str, max_images: Optional[int] = None):
    """``cifar-10-python.tar.gz`` batches (ref ``dataset_tool.py:188-218``)."""
    images, labels = [], []
    with tarfile.open(tarball, "r:gz") as tar:
        for batch in range(1, 6):
            member = tar.getmember(f"cifar-10-batches-py/data_batch_{batch}")
            with tar.extractfile(member) as f:
                data = pickle.load(f, encoding="latin1")
            images.append(np.asarray(data["data"], np.uint8).reshape(
                -1, 3, 32, 32))
            labels.append(data["labels"])
    images = np.concatenate(images).transpose(0, 2, 3, 1)  # NCHW -> NHWC
    labels = np.concatenate(labels).astype(np.int64)
    n = _maybe_min(len(images), max_images)

    def it():
        for i in range(n):
            yield dict(img=images[i], label=int(labels[i]))

    return n, it()


def open_mnist(images_gz: str, max_images: Optional[int] = None):
    """MNIST idx-gz pair, zero-padded 28->32 like the reference
    (``dataset_tool.py:222-251``)."""
    labels_gz = images_gz.replace("-images-idx3-ubyte.gz",
                                  "-labels-idx1-ubyte.gz")
    assert labels_gz != images_gz, images_gz
    with gzip.open(images_gz, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = images.reshape(-1, 28, 28)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant")
    n = _maybe_min(len(images), max_images)

    def it():
        for i in range(n):
            yield dict(img=images[i], label=int(labels[i]))

    return n, it()


def _decode_image_bytes(value: bytes) -> np.ndarray:
    """cv2-first, PIL-fallback decode (ref ``dataset_tool.py:166-176``
    inverted: PIL is always present here, cv2 optional)."""
    from PIL import Image

    try:
        return np.array(Image.open(_io.BytesIO(value)).convert("RGB"))
    except Exception:
        import cv2

        img = cv2.imdecode(np.frombuffer(value, dtype=np.uint8), 1)
        if img is None:
            raise IOError("image decode failed")
        return img[:, :, ::-1]  # BGR -> RGB


def open_lsun_lmdb(lmdb_dir: str, max_images: Optional[int] = None):
    """LSUN ``*_lmdb`` directory via the pure-Python b-tree reader
    (ref ``dataset_tool.py:158-185``).

    The returned count derives from the lmdb entry total; since the iterator
    skips undecodable values it may yield FEWER than ``n`` rows (see the
    module docstring: the count is an upper bound)."""
    from ic_gan_tpu_torch.io.lmdb_reader import LMDBReader

    reader = LMDBReader(lmdb_dir)
    n = _maybe_min(reader.entries, max_images)

    def it():
        emitted = 0
        for _key, value in reader:
            if emitted >= n:
                break
            try:
                img = _decode_image_bytes(value)
            except Exception as e:  # ref prints and skips undecodable rows
                print(f"skipping undecodable lmdb value: {e}")
                continue
            emitted += 1
            yield dict(img=img, label=None)
        reader.close()

    return n, it()


def open_source(source: str, max_images: Optional[int] = None):
    """Path-pattern dispatch (ref ``open_dataset``,
    ``dataset_tool.py:321-343``)."""
    if os.path.isdir(source):
        if source.rstrip("/").endswith("_lmdb") or os.path.exists(
            os.path.join(source, "data.mdb")
        ):
            return open_lsun_lmdb(source, max_images)
        return None  # caller uses the labeled image-folder walker
    if os.path.basename(source) == "cifar-10-python.tar.gz":
        return open_cifar10(source, max_images)
    if source.endswith("-images-idx3-ubyte.gz"):
        return open_mnist(source, max_images)
    if source.endswith(".zip"):
        return open_image_zip(source, max_images)
    raise IOError(f"unrecognized dataset source: {source}")


def as_chw_batches(
    reader: Tuple[int, Iterator[dict]],
    resolution: int,
    batch: int = 256,
):
    """Adapt a reader to the ``(uint8 CHW batch, int64 labels)`` stream
    ``build_xy_hdf5`` consumes: center-crop the long edge, resize, and
    replicate grayscale to 3 channels (the feature extractor and both
    backbones are RGB here)."""
    from PIL import Image

    _n, it = reader
    imgs, labels = [], []
    for row in it:
        img = row["img"]
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        h, w = img.shape[:2]
        if (h, w) != (resolution, resolution):
            pim = Image.fromarray(img)
            s = min(w, h)
            pim = pim.crop(((w - s) // 2, (h - s) // 2,
                            (w + s) // 2, (h + s) // 2))
            pim = pim.resize((resolution, resolution), Image.BILINEAR)
            img = np.asarray(pim, np.uint8)
        imgs.append(np.transpose(img, (2, 0, 1)))
        labels.append(-1 if row["label"] is None else int(row["label"]))
        if len(imgs) == batch:
            yield np.stack(imgs), np.asarray(labels, np.int64)
            imgs, labels = [], []
    if imgs:
        yield np.stack(imgs), np.asarray(labels, np.int64)
