"""BigGAN/IC-GAN training entry point: port of ``ic_gan_tpu/cli/train.py``
(reference ``BigGAN_PyTorch/run.py`` + ``trainer.py``).

    python -m ic_gan_tpu_torch.cli.train --json_config config.json \\
        [--set key=value ...] [--device cuda]
    torchrun --nproc_per_node 8 -m ic_gan_tpu_torch.cli.train --json_config ...

Accepts the reference's published BigGAN JSON configs (e.g.
``config_files/ImageNet/IC-GAN/icgan_res64.json``).  Runs on CUDA unless
``--device`` names another device.  A cluster launch trains data-parallel,
one process per device: under torchrun (its ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``), or with the config's
``jax_distributed``, ``coordinator_address`` ("host:port"),
``num_processes`` and ``process_id``, as the JAX CLI reads them
(``parallel.mesh.distributed_init``).  ``steps_per_epoch`` caps each epoch
(default: the dataset's size over the images of a step); ``resume`` or
``load_weights`` (a checkpoint suffix) continue from a saved state.  With
``eval_metrics`` (the default) the trainer evaluates FID and IS every
``test_every`` epochs against the reference moments under ``data_root``
(``eval.pipeline.make_train_eval_fn``); without that file it says so and
trains without eval.
"""

from __future__ import annotations

import argparse
import os

from ic_gan_tpu_torch.cli.config import parse_args, split_config


def main(argv=None):
    cfg = parse_args(argv)
    flags = argparse.ArgumentParser(add_help=False)
    flags.add_argument("--device", type=str, default="cuda")
    device = flags.parse_known_args(argv)[0].device
    if (cfg.get("jax_distributed", False) or cfg.get("coordinator_address")
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        from ic_gan_tpu_torch.parallel.mesh import distributed_init, local_device

        device = local_device(device)
        distributed_init(coordinator_address=cfg.get("coordinator_address"),
                         num_processes=cfg.get("num_processes"),
                         process_id=cfg.get("process_id"), device=device)

    model_cfg, train_cfg, trainer_cfg, data_kwargs = split_config(cfg)

    from ic_gan_tpu_torch.data.datasets import get_dataset_hdf5
    from ic_gan_tpu_torch.data.distributions import make_weights_for_balanced_classes
    from ic_gan_tpu_torch.train.trainer import Trainer

    dataset = get_dataset_hdf5(device=device, **data_kwargs)
    sampling_weights = None
    if cfg.get("longtail") and cfg.get("use_balanced_sampler"):
        labels = dataset.get_label(dataset.possible_sampling_idxs)
        sampling_weights = make_weights_for_balanced_classes(
            labels, model_cfg.n_classes,
            longtail_temperature=cfg.get("longtail_temperature", 1.0))
    eval_fn = None
    if cfg.get("eval_metrics", True):
        from ic_gan_tpu_torch.eval.pipeline import make_train_eval_fn

        try:
            eval_fn = make_train_eval_fn(cfg, device=device)
        except FileNotFoundError as e:
            print(f"eval disabled ({e})")

    trainer = Trainer(model_cfg, train_cfg, trainer_cfg, dataset, eval_fn=eval_fn,
                      sampling_weights=sampling_weights, device=device)
    if cfg.get("resume", False) or cfg.get("load_weights", ""):
        trainer.resume(suffix=cfg.get("load_weights", ""))
    trainer.run(steps_per_epoch=cfg.get("steps_per_epoch"))
    return trainer


if __name__ == "__main__":
    main()
