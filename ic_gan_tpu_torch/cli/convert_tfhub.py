"""Convert a TFHub BigGAN variable dump into the port's checkpoints: port of
``ic_gan_tpu/cli/convert_tfhub.py``.

The front end of ``io/tfhub_import.py``, after the reference's
``BigGAN_PyTorch/TFHub/converter.py`` CLI: the input is the intermediate
variable-dump HDF5 (``biggan-{res}.h5``; its producer needs TFHub, see
``dump_tfhub_to_hdf5``, converter.py:49-81), the outputs a native checkpoint
(``out``, ``io/checkpoint.py``: the generator alone, ``GeneratorState``),
an upstream-layout ``.pth`` state dict (``pth_out``) and a sample grid of
the σ-folded generator in bf16 (``sample_grid``), as the reference samples
after converting (converter.py:462-476).

    python -m ic_gan_tpu_torch.cli.convert_tfhub --set dump=biggan-128.h5 \\
        resolution=128 out=tfhub_biggan128 pth_out=biggan-128.pth \\
        sample_grid=samples.png [--device cuda]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.cli.config import parse_args


@dataclasses.dataclass
class GeneratorState:
    """A generator alone, as ``io/checkpoint.py`` saves and loads states."""

    g: nn.Module


def main(argv=None):
    """Returns ``(g, model_cfg)``: the converted generator, unfolded, in
    float32 on ``--device`` (CUDA unless named)."""
    from ic_gan_tpu_torch.cli.inference import device_flag
    from ic_gan_tpu_torch.io.tfhub_import import load_tfhub_generator

    cfg = parse_args(argv)
    res = cfg.get("resolution", 128)
    device = resolve_device(device_flag(argv))
    g, model_cfg = load_tfhub_generator(cfg["dump"], res, load_ema=not cfg.get("no_ema", False),
                                        device=device)
    print(f"converted TFHub biggan-{res}: {sum(p.numel() for p in g.parameters()):,} G params")

    if cfg.get("out"):
        from ic_gan_tpu_torch.io.checkpoint import save_checkpoint

        path = save_checkpoint(
            os.path.dirname(cfg["out"]) or ".", os.path.basename(cfg["out"]), GeneratorState(g),
            config={k: v for k, v in dataclasses.asdict(model_cfg).items() if k != "dtype"})
        print("wrote", path)

    if cfg.get("pth_out"):
        torch.save({k: v.detach().cpu() for k, v in g.state_dict().items()
                    if not k.endswith("accum_counter")}, cfg["pth_out"])
        print("wrote", cfg["pth_out"])

    if cfg.get("sample_grid"):
        import copy

        from ic_gan_tpu_torch.cli.inference import save_image_grid
        from ic_gan_tpu_torch.io.deploy import (
            cast_params,
            fold_spectral_norm,
            make_sampler,
            set_compute_dtype,
        )

        folded = cast_params(fold_spectral_norm(set_compute_dtype(copy.deepcopy(g),
                                                                  torch.bfloat16)))
        n = cfg.get("sample_batch", 16)
        z = torch.randn((n, model_cfg.effective_dim_z),
                        generator=torch.Generator().manual_seed(cfg.get("seed", 0)))
        y = np.random.RandomState(1).randint(0, model_cfg.n_classes, n)
        imgs = make_sampler(folded, batch_size=n, device=device)(z, y)
        save_image_grid(imgs, cfg["sample_grid"])
        print("wrote", cfg["sample_grid"])

    return g, model_cfg


if __name__ == "__main__":
    main()
