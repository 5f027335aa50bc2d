"""Generated samples as individual JPEGs: port of ``ic_gan_tpu/cli/sample.py``
(reference ``inference/sample.py:35-137``).

    python -m ic_gan_tpu_torch.cli.sample --json_config cfg.json \\
        --set pth_dir=weights/ data_root=data/ num_imgs=1000 out_dir=samples/ \\
        [--device cuda]

The conditioning comes from the HDF5 dataset under ``data_root`` (its
instance features and k-NN files), drawn in its balance mode
(``cli.inference.make_conditioned_sampler``).  Runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import os

import numpy as np

from ic_gan_tpu_torch.cli.config import parse_args, split_config
from ic_gan_tpu_torch.cli.inference import (
    conditioning_flags,
    device_flag,
    load_model_inference,
    make_conditioned_sampler,
)


def main(argv=None):
    cfg = parse_args(argv)
    sample_fn, model_cfg = load_model_inference(cfg, device=device_flag(argv))

    from ic_gan_tpu_torch.data.datasets import get_dataset_hdf5

    data_kwargs = split_config(cfg, inference=True)[3]
    # The network decides the conditioning the dataset must serve.
    class_cond, instance_cond = conditioning_flags(cfg, model_cfg)
    data_kwargs["class_cond"] |= class_cond
    data_kwargs["instance_cond"] |= instance_cond
    sample = make_conditioned_sampler(cfg, sample_fn, model_cfg, get_dataset_hdf5(**data_kwargs))

    from PIL import Image

    out_dir = cfg.get("out_dir", "samples")
    os.makedirs(out_dir, exist_ok=True)
    num, batch = cfg.get("num_imgs", 100), cfg.get("batch_size", 32)
    count = 0
    while count < num:
        b = min(batch, num - count)
        imgs, _ = sample(b)
        arr = ((imgs.float().cpu().numpy() + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        for i in range(b):
            Image.fromarray(arr[i]).save(os.path.join(out_dir, f"{count + i:06d}.jpg"))
        count += b
    print(f"wrote {count} JPEGs to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
