"""StyleGAN2-ADA training entry point: port of
``ic_gan_tpu/cli/train_stylegan2.py`` (reference ``stylegan2_ada_pytorch/
run.py`` + ``train.py``).

    python -m ic_gan_tpu_torch.cli.train_stylegan2 --json_config cfg.json \\
        --set data_root=... [--device cuda]

Accepts the reference's StyleGAN2 JSON configs (``cfg`` presets,
``aug``/``augpipe``, ``gamma``, ``kimg`` …) mapped onto the port's configs,
the reference's 'auto' heuristics included (``train.py:297-310``).  Runs on
CUDA unless ``--device`` names another device.  With ``eval_metrics`` (the
default) every snapshot is evaluated (FID, IS) against the reference
moments under ``data_root``; without that file the CLI says so and trains
without eval.
"""

from __future__ import annotations

import argparse

from ic_gan_tpu_torch.cli.config import data_config, parse_args


def setup_configs(cfg: dict):
    from ic_gan_tpu_torch.models.stylegan2 import StyleGAN2Config
    from ic_gan_tpu_torch.train.stylegan2_step import SG2TrainConfig
    from ic_gan_tpu_torch.train.stylegan2_trainer import SG2LoopConfig

    res = cfg.get("resolution", 256)
    spec = cfg.get("cfg", "auto")
    # Preset table (ref train.py:220-296).
    presets = {
        "auto": None,
        "stylegan2": dict(fmaps=1.0, lrate=0.002, gamma=10, ema=10, ramp=None,
                          map=8, mb=32),
        "paper256": dict(fmaps=0.5, lrate=0.0025, gamma=1, ema=20, ramp=None,
                         map=8, mb=64),
        "paper512": dict(fmaps=1.0, lrate=0.0025, gamma=0.5, ema=20, ramp=None,
                         map=8, mb=64),
        "paper1024": dict(fmaps=1.0, lrate=0.002, gamma=2, ema=10, ramp=None,
                          map=8, mb=32),
        "cifar": dict(fmaps=1.0, lrate=0.0025, gamma=0.01, ema=500, ramp=0.05,
                      map=2, mb=64),
    }
    p = presets.get(spec)
    if p is None:
        # 'auto' heuristics (ref train.py:297-310), single-host variant.
        mb = max(min(64, 4096 // res), 4)
        fmaps = 1.0 if res >= 512 else 0.5
        lrate = min(0.002, 0.0025 * (res / 1024) ** 0.5) if res >= 512 else 0.0025
        gamma = 0.0002 * (res ** 2) / mb
        p = dict(fmaps=fmaps, lrate=lrate, gamma=gamma, ema=mb * 10 / 32,
                 ramp=0.05, map=8, mb=mb)

    h_dim = cfg.get("h_dim", 2048 if cfg.get("instance_cond", True) else 0)
    c_dim = cfg.get("c_dim", 0)
    model = StyleGAN2Config(
        img_resolution=res,
        z_dim=cfg.get("z_dim", 512),
        c_dim=c_dim,
        h_dim=h_dim,
        w_dim=cfg.get("w_dim", 512),
        channel_base=int(p["fmaps"] * 32768),
        channel_max=512,
        num_mapping_layers=cfg.get("map", p["map"]),
        num_fp16_res=cfg.get("num_fp16_res", 4),
        conv_clamp=256.0,
    )
    train = SG2TrainConfig(
        glr=cfg.get("glr", p["lrate"]),
        dlr=cfg.get("dlr", p["lrate"]),
        r1_gamma=cfg.get("gamma", p["gamma"]),
        ema_kimg=p["ema"],
        ema_rampup=p["ramp"],
        ada_target=cfg.get("target", 0.6),
    )
    loop = SG2LoopConfig(
        experiment_name=cfg.get(
            "exp_name", cfg.get("experiment_name", "icgan_stylegan2")
        ),
        run_dir=cfg.get("outdir", cfg.get("run_dir", "training-runs")),
        total_kimg=cfg.get("kimg", 25000),
        kimg_per_tick=cfg.get("kimg_per_tick", 4),
        snapshot_ticks=cfg.get("snap", 50),
        batch_size=cfg.get("batch_size", p["mb"]),
        ada_enabled=cfg.get("aug", "ada") == "ada",
        augment_spec=cfg.get("augpipe", "bgc"),
        augment_p_init=cfg.get("p", 0.0),
        seed=cfg.get("seed", 0),
        enable_tb=not cfg.get("no_tb", False),
    )
    return model, train, loop


def main(argv=None):
    cfg = parse_args(argv)
    flags = argparse.ArgumentParser(add_help=False)
    flags.add_argument("--device", type=str, default="cuda")
    device = flags.parse_known_args(argv)[0].device
    model, train, loop = setup_configs(cfg)

    from ic_gan_tpu_torch.data.datasets import get_dataset_hdf5
    from ic_gan_tpu_torch.train.stylegan2_trainer import SG2Trainer

    data_kwargs = data_config(cfg)
    # The StyleGAN2 JSONs name their hdf5 files directly (data/root_feats/
    # root_nns, ref train.py:144-167) and use `mirror` for hflip aug.
    if cfg.get("data"):
        data_kwargs["xy_filename"] = cfg["data"]
    if cfg.get("root_feats"):
        data_kwargs["feats_filename"] = cfg["root_feats"]
    if cfg.get("root_nns"):
        data_kwargs["nns_filename"] = cfg["root_nns"]
    if cfg.get("mirror"):
        data_kwargs["hflip"] = True
    # StyleGAN2 consumes one-hot labels (label_onehot, ref train.py:144-167).
    dataset = get_dataset_hdf5(
        label_dim=model.c_dim, label_onehot=model.c_dim > 0, device=device, **data_kwargs
    )
    eval_fn = None
    if cfg.get("eval_metrics", True):
        try:
            eval_fn = make_eval_fn(cfg, device)
        except FileNotFoundError as e:
            print(f"eval disabled ({e})")

    trainer = SG2Trainer(model, train, loop, dataset, eval_fn=eval_fn, device=device)
    trainer.run(max_steps=cfg.get("max_steps"))
    return trainer


def make_eval_fn(cfg: dict, device):
    """The snapshot eval as the JAX CLI builds it: FID and IS of
    ``num_inception_images`` EMA samples against the reference moments under
    ``data_root`` (resolution 256 unless the config says), z drawn from
    generators seeded 123 + the batch's count (``eval.pipeline.
    make_train_eval_fn``).  ``FileNotFoundError`` when the moments file is
    missing."""
    from ic_gan_tpu_torch.eval.pipeline import make_train_eval_fn

    return make_train_eval_fn(dict(cfg, resolution=cfg.get("resolution", 256)), device,
                              seed=123, draw=lambda tr, b, gen: (tr.sample_fn(b, gen)[0], None))


if __name__ == "__main__":
    main()
