"""The IC-GAN demo, variations of a user's image: port of
``ic_gan_tpu/cli/demo.py`` (reference ``predict.py:43-307``, the cog demo).

    python -m ic_gan_tpu_torch.cli.demo --set input_image=photo.jpg \\
        feature_extractor_weights=swav_800ep_pretrain.pth.tar pth_dir=weights/ \\
        num_samples=16 out_path=variations.png [--device cuda]

The image's centre square goes through ResNet-50 (``models.resnet``; SwAV or
torchvision weights from ``feature_extractor_weights``, random ones from a
seed without) to L2-normalized 2048-d instance features; the generator draws
``num_samples`` images conditioned on them, and the grid ranks them by the
cosine similarity of their features to the input's, taken by the same
network.  (The JAX package ranks with a freshly initialized ResNet-50 even
when weights are given: ROADMAP.md §C.)  Runs on CUDA unless ``--device``
names another device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ic_gan_tpu_torch.cli.config import parse_args
from ic_gan_tpu_torch.cli.inference import (
    device_flag,
    latent_dim,
    load_model_inference,
    save_image_grid,
)


def feature_extractor(weights_path=None, device=None):
    """The demo's ResNet-50: the state dict at ``weights_path`` (a
    ``state_dict`` entry read when the file has one), or random weights from
    a generator seeded 0."""
    from ic_gan_tpu_torch.models.resnet import ResNet50, load_torch_resnet50

    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        return load_torch_resnet50(sd.get("state_dict", sd), device=device)
    return ResNet50(device=device, generator=torch.Generator(device=device).manual_seed(0))


@torch.inference_mode()
def features(net, images_01: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """(N, 3, H, W) images in [0, 1] → L2-normalized pooled features."""
    from ic_gan_tpu_torch.models.resnet import preprocess

    device = next(net.parameters()).device
    pooled, _ = net(preprocess(images_01.to(device), size=resolution))
    return torch.nn.functional.normalize(pooled, dim=1)


def extract_features(image_path: str, net, resolution: int = 224) -> np.ndarray:
    """A user's image → its L2-normalized 2048-d instance features (ref
    ``predict.py``: the centre square, bicubic to 224²)."""
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    x = torch.from_numpy(np.asarray(img, np.float32) / 255.0).permute(2, 0, 1)[None]
    return features(net, x, resolution)[0].cpu().numpy()


def rank_by_cosine(gen_feats: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Indices of the generated samples by cosine similarity to the target's
    features, best first."""
    g = gen_feats / np.linalg.norm(gen_feats, axis=1, keepdims=True)
    t = target / np.linalg.norm(target)
    return np.argsort(-(g @ t), kind="stable")


def main(argv=None):
    cfg = parse_args(argv)
    device = device_flag(argv)
    sample_fn, model_cfg = load_model_inference(cfg, device=device)
    net = feature_extractor(cfg.get("feature_extractor_weights"), device=device)
    target = extract_features(cfg["input_image"], net)

    n = cfg.get("num_samples", 16)
    dim_z = latent_dim(model_cfg)
    z = torch.randn((n, dim_z), generator=torch.Generator().manual_seed(cfg.get("seed", 0)))
    z = z * math.sqrt(cfg.get("z_var", 1.0))
    f = np.repeat(target[None], n, axis=0)
    imgs = sample_fn(z, None, f)
    # Ranked by the network that took the target's features.
    gen = features(net, (torch.from_numpy(imgs).permute(0, 3, 1, 2) + 1) / 2)
    order = rank_by_cosine(gen.cpu().numpy(), target)

    out = cfg.get("out_path", "variations.png")
    save_image_grid(imgs[order], out, nrow=int(np.ceil(np.sqrt(n))))
    print(f"wrote {n} ranked variations to {out}")
    return out, order


if __name__ == "__main__":
    main()
