"""The port's dataset, k-NN and StyleGAN2 CLI configuration against the JAX
package, on the CPU.

A 16-image HDF5 file with labels, its features (and their flipped twins)
and its k-NN file, as ``tests/test_sg2_trainer.py`` writes them: the port's
``HDF5Dataset`` and the JAX one, from one seed, draw the same batches (the
port's images NCHW).  ``knn`` against ``feature_bank.knn``; the CLI's presets
and 'auto' heuristics, ``parse_args`` and the data keyword arguments against
the JAX CLI's.
"""

import dataclasses
import json

import numpy as np
import pytest

from ic_gan_tpu.cli import config as jconfig
from ic_gan_tpu.cli import train_stylegan2 as jcli
from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.data import feature_bank as jbank
from ic_gan_tpu_torch.cli import config as tconfig
from ic_gan_tpu_torch.cli import train_stylegan2 as tcli
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.data import feature_bank as tbank

h5py = pytest.importorskip("h5py")

N, RES, F, K = 16, 8, 12, 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("hdf5")
    rng = np.random.RandomState(0)
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    assert names == tdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    feats = rng.randn(N, F).astype(np.float32)
    with h5py.File(root / names["xy"], "w") as f:
        f.create_dataset("imgs", data=rng.randint(0, 256, (N, 3, RES, RES), dtype=np.uint8))
        f.create_dataset("labels", data=rng.randint(0, 5, (N,)).astype(np.int64))
    with h5py.File(root / names["feats"], "w") as f:
        f.create_dataset("feats", data=feats)
        f.create_dataset("feats_hflip", data=rng.randn(N, F).astype(np.float32))
    idx, radii = jbank.knn(feats / np.linalg.norm(feats, axis=1, keepdims=True), K + 1)
    with h5py.File(root / names["nns"], "w") as f:
        f.create_dataset("sample_nns", data=idx)
        f.create_dataset("sample_nns_radius", data=radii)
    return root, names


def _datasets(files, **kw):
    root, names = files
    args = dict(root=str(root / names["xy"]), root_feats=str(root / names["feats"]),
                root_nns=str(root / names["nns"]), k_nn=K, feature_dim=F, seed=3, **kw)
    return jdata.HDF5Dataset(**args), tdata.HDF5Dataset(**args)


@pytest.mark.parametrize("kw", [
    dict(label_dim=5, label_onehot=True, hflip=True, feature_augmentation=True),
    dict(load_labels=False, which_nn_balance="nnclass_balance", load_in_mem_feats=False),
])
def test_hdf5_dataset_draws_match_jax(files, kw):
    """Three ``sample_batch`` and three ``sample_conditioning_instance_balance``
    calls, interleaved as the trainer calls them: indices, labels, features
    and radii exact, images to 1e-6 (x·(2/255) − 1 in f32 on both sides)."""
    jd, td = _datasets(files, **kw)
    assert len(jd) == len(td) == N and td.resolution == RES
    for _ in range(3):
        jb, tb = jd.sample_batch(4), td.sample_batch(4)
        assert tb.images.shape == (4, 3, RES, RES) and tb.images.dtype == np.float32
        np.testing.assert_allclose(np.transpose(tb.images, (0, 2, 3, 1)), jb.images, atol=1e-6)
        for name in ("labels", "features", "radii"):
            a, b = getattr(jb, name), getattr(tb, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=name)
        (jl, jh), (tl, th) = (d.sample_conditioning_instance_balance(4) for d in (jd, td))
        np.testing.assert_array_equal(th, jh)
        assert (jl is None) == (tl is None)
        if jl is not None:
            np.testing.assert_array_equal(tl, jl)


def test_in_process_knn_matches_jax(files):
    """Without a k-NN file the table is computed in process: the port's
    ``knn`` on the CPU against JAX's, indices exact, radii 1e-5; the
    datasets built on either hold the same table."""
    rng = np.random.RandomState(1)
    feats = rng.randn(40, F).astype(np.float32)
    (ji, jr), (ti, tr) = jbank.knn(feats, 5, block=16), tbank.knn(feats, 5, block=16,
                                                                   device="cpu")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tr, jr, atol=1e-5)
    assert (ti[:, 0] == np.arange(40)).all()        # each point its own first neighbour
    root, names = files
    args = dict(root=str(root / names["xy"]), root_feats=str(root / names["feats"]), k_nn=K,
                feature_dim=F)
    jd, td = jdata.HDF5Dataset(**args), tdata.HDF5Dataset(**args, device="cpu")
    np.testing.assert_array_equal(td.sample_nns, jd.sample_nns)
    np.testing.assert_allclose(td.sample_nn_radius, jd.sample_nn_radius, atol=1e-5)


def test_get_dataset_hdf5_matches_jax_and_refuses_filter_hd(files):
    """The factory as JAX's; ``filter_hd`` without the hamming index files
    refuses as JAX's does (the filter itself:
    ``test_torch_port_prepare_data.py``)."""
    root, names = files
    kw = dict(resolution=RES, data_path=str(root), k_nn=K, feature_extractor="classification",
              feature_dim=F, seed=2, label_dim=5, label_onehot=True)
    jd, td = jdata.get_dataset_hdf5(**kw), tdata.get_dataset_hdf5(**kw)
    np.testing.assert_array_equal(td.sample_batch(4).labels, jd.sample_batch(4).labels)
    for mod in (tdata, jdata):
        with pytest.raises(FileNotFoundError, match="cocostuff_val2_all_idxs"):
            mod.get_dataset_hdf5(filter_hd=1, **kw)
    assert tdata.kmeans_filename(RES, "coco", k=100) == jdata.kmeans_filename(RES, "coco", k=100)


@pytest.mark.parametrize("cfg", [
    {"cfg": p} for p in ("stylegan2", "paper256", "paper512", "paper1024", "cifar")
] + [{"resolution": r} for r in (128, 256, 512)] + [
    {"resolution": 64, "cfg": "auto", "gamma": 2.5, "kimg": 10, "aug": "noaug", "p": 0.1,
     "batch_size": 8, "map": 2, "z_dim": 64, "c_dim": 10, "instance_cond": False,
     "no_tb": True, "exp_name": "e", "outdir": "o", "snap": 3, "mirror": 1},
])
def test_setup_configs_match_jax(cfg):
    for got, want in zip(tcli.setup_configs(cfg), jcli.setup_configs(cfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parse_args_and_data_config_match_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"resolution": 128, "cfg": "paper256", "data_root": "d",
                                "instance_cond": True, "k_nn": 5, "hflips": True,
                                "filter_hd": 3, "gpus": 8}))
    argv = ["--json_config", str(path), "--set", "kimg=3", "aug=noaug", "p=0.25",
            "which_knn_balance=nnclass_balance", "--device", "cpu"]
    cfg = tconfig.parse_args(argv)
    assert cfg == jconfig.parse_args(argv)
    assert cfg["kimg"] == 3 and cfg["aug"] == "noaug" and cfg["p"] == 0.25
    assert tconfig.data_config(cfg) == jconfig.split_config(cfg, backbone="stylegan2")[3]
    assert tconfig.validate_config(cfg) == []
    with pytest.warns(UserWarning, match="G_ch"):
        tconfig.validate_config({"G_ch": 64})
