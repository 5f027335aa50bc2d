"""Image-folder helpers: the part of ``ic_gan_tpu/data/image_datasets.py``
the inference CLIs use.  The image-folder and COCO datasets wait for
ROADMAP.md A.14."""

from __future__ import annotations


def _center_crop_resize(img, resolution: int):
    """A PIL image's centered square crop of its short side, resized to
    ``resolution``² bilinearly (ref ``generate_images.py:198-210``)."""
    from PIL import Image

    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    return img.resize((resolution, resolution), Image.BILINEAR)
