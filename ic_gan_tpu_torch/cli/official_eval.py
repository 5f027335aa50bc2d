"""Official TF1-Inception IS/FID over saved samples, without TensorFlow:
port of ``ic_gan_tpu/cli/official_eval.py``.

Mirror of ``data_utils/inception_tf13.py:115-320`` (the reference's
"official numbers" script): load generated samples (the ``samples*.npz`` of
``cli/test.py sample_npz=1``, or a ``samples*.pickle`` as the reference's
``--sample_npz`` writes) or ground-truth images from an ``*_xy.hdf5``, run
them through the frozen 2015 Inception graph (``eval/tf_inception.py``),
print the 10-split IS, and save the pool_3 moments for FID under the
reference's file names.  ImageNet-LT ground-truth mode also writes the
many/low/few stratified moments (``inception_tf13.py:300-320``).  The
HDF5 path imports ``h5py`` when it runs.  Runs on CUDA unless ``--device``
names another device.

    python -m ic_gan_tpu_torch.cli.official_eval --set samples=samples.npz \
        out_dir=. pb_path=/path/classify_image_graph_def.pb
    python -m ic_gan_tpu_torch.cli.official_eval --set use_ground_truth_data=1 \
        data_root=... which_dataset=imagenet resolution=64 split=val

FID between two saved moment files:

    python -m ic_gan_tpu_torch.cli.official_eval --set \
        fid_a=TF_pool.npz fid_b=imagenet_val_res64_tf_inception_moments_ground_truth.npz
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ic_gan_tpu_torch import resolve_device
from ic_gan_tpu_torch.cli.config import parse_args


def _load_samples(path: str) -> np.ndarray:
    """→ NHWC float images in [-1, 1] (the IS path re-normalizes like the
    reference, ``inception_tf13.py:132-135``)."""
    if path.endswith((".pickle", ".pkl")):
        with open(path, "rb") as f:
            x = pickle.load(f)["x"]  # NCHW float [-1,1] (ref :252-258)
    else:
        x = np.load(path)["x"]  # NCHW uint8 [0,255] (cli/test.py export)
    x = np.asarray(x)
    if x.ndim == 4 and x.shape[1] in (1, 3):
        x = x.transpose(0, 2, 3, 1)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0 * 2.0 - 1.0
    return x


def _load_ground_truth(cfg) -> tuple:
    import h5py

    prefix = {"imagenet": "ILSVRC", "imagenet_lt": "ILSVRC",
              "coco": "COCO"}[cfg.get("which_dataset", "imagenet")]
    name = "%s%i%s%s%s_xy.hdf5" % (
        prefix, cfg.get("resolution", 64),
        "longtail" if cfg.get("which_dataset") == "imagenet_lt"
        and cfg.get("split", "train") == "train" else "",
        "_val" if cfg.get("split") == "val" else "",
        "_test" if cfg.get("split") == "val"
        and cfg.get("which_dataset") == "coco" else "",
    )
    with h5py.File(os.path.join(cfg["data_root"], name), "r") as f:
        imgs = f["imgs"][:]
        labels = f["labels"][:]
    return imgs.transpose(0, 2, 3, 1), labels  # uint8 NHWC [0,255]


def main(argv=None):
    from ic_gan_tpu_torch.cli.inference import device_flag

    cfg = parse_args(argv)
    device = resolve_device(device_flag(argv))

    if cfg.get("fid_a") and cfg.get("fid_b"):
        from ic_gan_tpu_torch.eval.fid import frechet_distance

        a, b = np.load(cfg["fid_a"]), np.load(cfg["fid_b"])
        fid = frechet_distance(a["mu"], a["sigma"], b["mu"], b["sigma"], device=device)
        print({"official_FID": round(float(fid), 4)})
        return {"FID": float(fid)}

    from ic_gan_tpu_torch.eval.tf_inception import OfficialTF1Evaluator, evaluate_images

    evaluator = OfficialTF1Evaluator(cfg.get("pb_path"), device=device)
    out_dir = cfg.get("out_dir", ".")
    os.makedirs(out_dir, exist_ok=True)

    if cfg.get("use_ground_truth_data", False):
        imgs, labels = _load_ground_truth(cfg)
        out = evaluate_images(evaluator, imgs.astype(np.float32),
                              batch=cfg.get("batch_size", 100),
                              normalize=False)
        # Reference ground-truth moment filename (inception_tf13.py:271-281).
        np.savez(os.path.join(out_dir, "%s%s_res%i_tf_inception_moments_ground_truth.npz" % (
            cfg.get("which_dataset", "imagenet"),
            "_val" if cfg.get("split") == "val" else "",
            cfg.get("resolution", 64))),
            mu=out["mu"], sigma=out["sigma"])
        # LT stratified moments (inception_tf13.py:300-320).
        spc_path = cfg.get("samples_per_class_path", "")
        if (cfg.get("which_dataset") == "imagenet_lt"
                and cfg.get("split") == "val" and spc_path):
            spc = np.load(spc_path, allow_pickle=True)
            pool = out["pool"]
            strata = {
                "_many": pool[spc[labels] >= 100],
                "_low": pool[(spc[labels] < 100) & (spc[labels] > 20)],
                "_few": pool[spc[labels] <= 20],
            }
            for strat, p in strata.items():
                np.savez(os.path.join(out_dir,
                         "%s_res%i_tf_inception_moments_ground_truth%s.npz" % (
                             cfg["which_dataset"], cfg.get("resolution", 64),
                             strat)),
                         mu=np.mean(p, axis=0), sigma=np.cov(p, rowvar=False))
    else:
        imgs = _load_samples(cfg["samples"])
        out = evaluate_images(evaluator, imgs,
                              batch=cfg.get("batch_size", 100), normalize=True)
        np.savez(os.path.join(out_dir, cfg.get("pool_npz", "TF_pool.npz")),
                 mu=out["mu"], sigma=out["sigma"])

    print({"IS_mean": round(out["IS_mean"], 4),
           "IS_std": round(out["IS_std"], 4)})
    return out


if __name__ == "__main__":
    main()
