"""The port's batch loader (``ic_gan_tpu_torch/data/loader.py``) against the
JAX package's native one (``ic_gan_tpu/native``), on the CPU.

uint8 NCHW batches holding every one of the 256 values, with and without
the flip and the normalization: the port's float32 NCHW output equals the
native loader's NHWC output, transposed, bit for bit.  The ``"norm"`` table
equals ``HDF5Dataset._norm`` of both packages; ``gather_rows`` equals JAX's;
and a small HDF5 file's ``sample_batch`` equals the JAX dataset's, draw for
draw and image bit for image bit.
"""

import types

import numpy as np
import pytest
import torch

from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.native import build as jnative
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.data import loader

h5py = pytest.importorskip("h5py")

N, RES, F, K = 12, 16, 8, 3


def _all_values(batch=4, seed=0):
    """(batch, 3, RES, RES) uint8, each image every value 256 three times
    over, shuffled."""
    rng = np.random.default_rng(seed)
    vals = np.tile(np.arange(256, dtype=np.uint8), 3 * RES * RES // 256)
    return np.stack([rng.permutation(vals).reshape(3, RES, RES) for _ in range(batch)])


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("apply_norm", [True, False])
@pytest.mark.parametrize("flip", [None, [0, 1, 1, 0]])
def test_normalize_batch_is_the_native_loader_bit_for_bit(apply_norm, flip):
    assert jnative.build_and_import() is not None, \
        "the native loader did not build: JAX would fall back to _norm's formula"
    u8 = _all_values()
    mask = None if flip is None else np.asarray(flip, np.uint8)
    want = jnative.normalize_batch(u8, mask, apply_norm).transpose(0, 3, 1, 2)
    got = loader.normalize_batch(u8, mask, apply_norm, device="cpu")
    assert got.dtype == torch.float32 and got.shape == u8.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # The table holds the native arithmetic's 256 results.
    table = jnative.normalize_batch(np.arange(256, dtype=np.uint8).reshape(1, 1, 1, 256),
                                    None, apply_norm).reshape(-1)
    np.testing.assert_array_equal(_bits(loader.norm_table("loader", apply_norm)), _bits(table))


@pytest.mark.parametrize("apply_norm", [True, False])
def test_norm_table_is_hdf5_dataset_norm(apply_norm):
    """The moments path's formula: ``(x/255 − 0.5)·2`` of both packages'
    ``HDF5Dataset._norm``; it differs from the native loader's formula in
    the last bit for some values."""
    u8 = _all_values(2, seed=1)
    holder = types.SimpleNamespace(apply_norm=apply_norm)
    got = loader.normalize_batch(u8, None, apply_norm, device="cpu", formula="norm").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(tdata.HDF5Dataset._norm(holder, u8)))
    np.testing.assert_array_equal(_bits(got), _bits(jdata.HDF5Dataset._norm(holder, u8)))
    differ = loader.norm_table("norm", apply_norm) != loader.norm_table("loader", apply_norm)
    assert differ.any() == apply_norm
    with pytest.raises(ValueError, match="formula"):
        loader.norm_table("other")
    with pytest.raises(ValueError, match="uint8"):
        loader.normalize_batch(u8.astype(np.float32), device="cpu")


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, 33)
    got = loader.gather_rows(src, idx, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jnative.gather_rows(src, idx))
    assert loader.gather_rows(src, [], device="cpu").shape == (0, 7)
    for bad in ([50], [-1]):
        with pytest.raises(IndexError):
            loader.gather_rows(src, bad, device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.RandomState(3)
    names = jdata.hdf5_filenames(RES, "imagenet", k_nn=K)
    feats = rng.randn(N, F).astype(np.float32)
    with h5py.File(root / names["xy"], "w") as f:
        f.create_dataset("imgs", data=rng.randint(0, 256, (N, 3, RES, RES), dtype=np.uint8))
        f.create_dataset("labels", data=rng.randint(0, 4, (N,)).astype(np.int64))
    with h5py.File(root / names["feats"], "w") as f:
        f.create_dataset("feats", data=feats)
    sims = feats @ feats.T
    nns = np.argsort(-sims, axis=1)[:, :K + 1]
    with h5py.File(root / names["nns"], "w") as f:
        f.create_dataset("sample_nns", data=nns.astype(np.int64))
        f.create_dataset("sample_nns_radius", data=np.ones(N, np.float32))
    return root, names


def test_sample_batch_matches_jax_draw_for_draw(files):
    root, names = files
    args = dict(root=str(root / names["xy"]), root_feats=str(root / names["feats"]),
                root_nns=str(root / names["nns"]), k_nn=K, feature_dim=F, seed=5, hflip=True)
    jd, td = jdata.HDF5Dataset(**args), tdata.HDF5Dataset(**args, device="cpu")
    for _ in range(3):
        jb, tb = jd.sample_batch(6), td.sample_batch(6)
        assert torch.is_tensor(tb.images) and tb.images.device.type == "cpu"
        np.testing.assert_array_equal(_bits(tb.images.numpy()),
                                      _bits(np.transpose(jb.images, (0, 3, 1, 2))))
        for name in ("labels", "features", "radii"):
            np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
