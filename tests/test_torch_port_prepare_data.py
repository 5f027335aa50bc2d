"""The port's data-preparation layer (``io/lmdb_reader.py``,
``data/archive_readers.py``, ``data/image_datasets.py``, the k-means of
``data/feature_bank.py``, ``cli/prepare_data.py``,
``cli/store_coco_images.py``) and its LPIPS network (``models/vgg.py``,
``eval/metrics.make_lpips_feature_fn``) against the JAX package's, on the
CPU, at toy size with inputs from numpy seeds.

- Exactly as JAX: the archive readers and the LMDB reader on the JAX tests'
  fixture builders; ``ImageFolderDataset`` batches with an ImageNet-LT txt
  split; ``CocoStuffDataset`` ids and objects from a synthetic JSON; the
  class sets, the hamming index files and their filter, through
  ``get_dataset_hdf5`` too; ``store_coco_images`` in both modes.
- ``iter_image_folder`` + ``build_xy_hdf5`` bit for bit; the feature file
  against JAX's ResNet-50 on the same ``.pth`` and images, with and without
  the flip bank, 1e-4 of each output's largest value; ``build_nns`` and
  ``build_kmeans`` against JAX's on the port's feature file (well-separated
  blobs: indices equal, radii and centroids 1e-5 relative); one Lloyd step
  from the same centroids, 1e-6 relative.
- The slice as a whole: ``prepare_data.main`` on a toy folder, read by both
  packages' ``get_dataset_hdf5``: the same neighbours, k-means samples and
  batches.
- VGG16 and LPIPS against JAX on shared weights at 32² and 64² (features,
  distances 1e-4 relative); the three checkpoint loaders against JAX's;
  ``make_lpips_feature_fn`` through ``compute_ppl``; PPL's pair sharing its
  noise.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ic_gan_tpu.cli import prepare_data as jprep
from ic_gan_tpu.cli import store_coco_images as jcoco
from ic_gan_tpu.data import archive_readers as jarch
from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.data import feature_bank as jbank
from ic_gan_tpu.data import image_datasets as jimg
from ic_gan_tpu.io.lmdb_reader import LMDBReader as JLMDBReader
from ic_gan_tpu.models import resnet as jresnet
from ic_gan_tpu.models import vgg as jvgg
from ic_gan_tpu_torch.cli import prepare_data as tprep
from ic_gan_tpu_torch.cli import store_coco_images as tcoco
from ic_gan_tpu_torch.data import archive_readers as tarch
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.data import feature_bank as tbank
from ic_gan_tpu_torch.data import image_datasets as timg
from ic_gan_tpu_torch.eval import metrics as tmetrics
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.io.lmdb_reader import LMDBReader as TLMDBReader
from ic_gan_tpu_torch.models import vgg as tvgg
from test_archive_readers import _make_cifar, _make_mnist, _make_zip, _png_bytes, build_lmdb
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401
from test_torch_port_inference import _random_resnet

h5py = pytest.importorskip("h5py")


def _rows(reader):
    n, it = reader
    return n, [(r["img"], r["label"]) for r in it]


def _same_rows(got, want):
    (n_got, rows_got), (n_want, rows_want) = got, want
    assert n_got == n_want and len(rows_got) == len(rows_want) > 0
    for (gi, gl), (wi, wl) in zip(rows_got, rows_want):
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl


# --- the readers ---------------------------------------------------------------------

def _lmdb_source(tmp_path):
    rng = np.random.RandomState(1)
    items = [(f"i{i}".encode(), _png_bytes(rng.randint(0, 255, (24, 32, 3), np.uint8)))
             for i in range(5)]
    items.insert(2, (b"junk", b"not an image at all"))
    items.append((b"z", rng.bytes(9000)))     # an overflow value that fails to decode
    return str(build_lmdb(tmp_path / "bedroom_train_lmdb", items, per_leaf=2))


def _zip_source(tmp_path):
    _make_zip(tmp_path / "d.zip", size=(20, 24))
    return str(tmp_path / "d.zip")


def _cifar_source(tmp_path):
    _make_cifar(tmp_path / "cifar-10-python.tar.gz", per_batch=2)
    return str(tmp_path / "cifar-10-python.tar.gz")


def _mnist_source(tmp_path):
    return _make_mnist(tmp_path)[0]


@pytest.mark.parametrize("make", [_lmdb_source, _zip_source, _cifar_source, _mnist_source])
def test_archive_readers_match_jax(make, tmp_path):
    """``open_source`` (capped and not) and ``as_chw_batches`` at 16² give
    JAX's rows exactly; the LMDB reader the same (key, value) pairs."""
    src = make(tmp_path)
    _same_rows(_rows(tarch.open_source(src)), _rows(jarch.open_source(src)))
    _same_rows(_rows(tarch.open_source(src, max_images=3)),
               _rows(jarch.open_source(src, max_images=3)))
    got = list(tarch.as_chw_batches(tarch.open_source(src), 16, batch=3))
    want = list(jarch.as_chw_batches(jarch.open_source(src), 16, batch=3))
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if make is _lmdb_source:
        with TLMDBReader(src) as t, JLMDBReader(src) as j:
            assert t.entries == j.entries and list(t) == list(j)


# --- image folders and COCO-Stuff ------------------------------------------------------

def _image_folder(root, classes=3, per_class=2, seed=0):
    """``classes`` class folders of ``per_class`` PNGs of assorted shapes."""
    rng = np.random.RandomState(seed)
    shapes = [(40, 36), (48, 48), (30, 50), (33, 41)]
    for c in range(classes):
        os.makedirs(root / f"n{c:03d}", exist_ok=True)
        for i in range(per_class):
            h, w = shapes[(c + i) % len(shapes)]
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / f"n{c:03d}" / f"img{i}.png")
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _image_folder(tmp_path_factory.mktemp("folder") / "images")


def test_image_folder_dataset_matches_jax(folder, tmp_path):
    """Batches of the folder walk and of an ImageNet-LT txt split, equal."""
    split = tmp_path / "lt.txt"
    split.write_text("n002/img1.png 7\nn000/img1.png 1\nbad-line\nn001/img0.png 4\n")
    for kw in (dict(), dict(longtail=True, split_file=str(split))):
        t, j = (m.ImageFolderDataset(str(folder), resolution=16, **kw) for m in (timg, jimg))
        assert t.samples == j.samples and len(t) == len(j)
        idxs = np.arange(len(t))[::-1]
        for a, b in zip(t.batch(idxs), j.batch(idxs)):
            np.testing.assert_array_equal(a, b)


def _coco_files(root, seed=0):
    """Synthetic COCO instances/stuff JSONs: a training split of 12 images
    (written as JPEGs) and an eval split of 1,400 (annotations only: the
    eval partition keeps the filtered images from 1,024 on); 4 instance categories
    and 2 stuff ones ('other' among them), boxes of random sizes, some
    crowds."""
    rng = np.random.RandomState(seed)
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(("cat", "dog", "car", "bus"))]
    stuff_cats = [{"id": 90, "name": "grass"}, {"id": 91, "name": "other"}]
    paths = {}
    for split, n, base in (("train", 12, 0), ("eval", 1400, 100)):
        os.makedirs(root / split, exist_ok=True)
        images, inst, stuff = [], [], []
        for k in range(n):
            img_id = base + k
            w, h = int(rng.randint(30, 60)), int(rng.randint(30, 60))
            if split == "train":
                Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                    root / split / f"{img_id}.jpg")
            images.append({"id": img_id, "file_name": f"{img_id}.jpg", "width": w,
                           "height": h})
            lo = 1 if split == "train" else 3
            for _ in range(int(rng.randint(lo, 7))):
                bw, bh = rng.uniform(lo, w), rng.uniform(lo, h)
                inst.append({"image_id": img_id, "bbox": [0, 0, bw, bh],
                             "category_id": int(rng.randint(1, 5)),
                             "iscrowd": int(rng.rand() < 0.1)})
            if rng.rand() < 0.95:
                stuff.append({"image_id": img_id, "bbox": [0, 0, w / 2, h / 2],
                              "category_id": int(rng.choice([90, 91]))})
        for name, data in (("instances", {"images": images, "annotations": inst,
                                          "categories": cats}),
                           ("stuff", {"images": images, "annotations": stuff,
                                      "categories": stuff_cats})):
            p = root / f"{name}_{split}.json"
            p.write_text(json.dumps(data))
            paths[f"{name}_{split}"] = str(p)
    return paths


def test_coco_stuff_hamming_indexes_and_store_gt_match_jax(tmp_path):
    """``CocoStuffDataset`` (ids, objects, batches), ``coco_class_sets``,
    ``store_coco_images`` ``build_hd`` (the index files), ``filter_by_hd`` at
    distance 0 and 1, and ``store_gt`` with and without the filter: every
    output equal to JAX's."""
    paths = _coco_files(tmp_path)
    kw = dict(image_dir=str(tmp_path / "train"), instances_json=paths["instances_train"],
              stuff_json=paths["stuff_train"], min_objects_per_image=1, resolution=16)
    for split_kw in (dict(split="train"), dict(split="val"), dict(stuff_only=False)):
        t, j = timg.CocoStuffDataset(**kw, **split_kw), jimg.CocoStuffDataset(**kw, **split_kw)
        assert t.image_ids == j.image_ids and len(t) > 0
        assert dict(t.id_to_objects) == dict(j.id_to_objects)
        assert timg.coco_class_sets(t) == jimg.coco_class_sets(j)
        flip = np.arange(len(t)) % 2 == 0
        np.testing.assert_array_equal(t.get_images(np.arange(len(t)), flip),
                                      j.get_images(np.arange(len(j)), flip))
        for a, b in zip(t.batch(np.arange(len(t))), j.batch(np.arange(len(j)))):
            np.testing.assert_array_equal(a, b)
    cfg = dict(mode="build_hd", resolution=16, image_dir_train=str(tmp_path / "train"),
               image_dir_eval=str(tmp_path / "eval"),
               instances_json_train=paths["instances_train"],
               instances_json_eval=paths["instances_eval"],
               stuff_json_train=paths["stuff_train"], stuff_json_eval=paths["stuff_eval"])
    outs = {}
    for name, mod, extra in (("t", tcoco, ["--device", "cpu"]), ("j", jcoco, [])):
        d = tmp_path / f"hd_{name}"
        argv = ["--set"] + [f"{k}={json.dumps(v)}" for k, v in
                            dict(cfg, index_dir=str(d)).items()] + extra
        outs[name] = (mod.main(argv), d)
    (t_all, t_by), td = outs["t"]
    (j_all, j_by), jd = outs["j"]
    np.testing.assert_array_equal(t_all, j_all)
    assert len(t_all) > 0 and len(t_by) > 1
    assert [list(b) for b in t_by] == [list(b) for b in j_by]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for f in os.listdir(jd):
        a, b = (np.load(d / f, allow_pickle=True) for d in (td, jd))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert [list(np.atleast_1d(x)) for x in a] == [list(np.atleast_1d(x)) for x in b]
    # A direct call whose buckets are ragged.
    ids, sets = [5, 6, 7, 8], [{1, 2}, {1}, {3, 4, 5}, {9}]
    t_out = timg.build_hd_indexes(ids, sets, [{1, 2}, {3}], str(tmp_path / "d_t"), device="cpu")
    j_out = jimg.build_hd_indexes(ids, sets, [{1, 2}, {3}], str(tmp_path / "d_j"))
    np.testing.assert_array_equal(t_out[0], j_out[0])
    assert t_out[1] == j_out[1]
    files = [str(td / "cocostuff_val2_all_idxs.npy"),
             str(td / "val2_image_ids_by_hd_75ktraining_im.npy")]
    for dist in (0, 1):
        np.testing.assert_array_equal(timg.filter_by_hd(dist, *files),
                                      jimg.filter_by_hd(dist, *files))
    # store_gt over a COCO val xy file, unfiltered and at distance 0.
    data = tmp_path / "coco_data"
    os.makedirs(data)
    imgs = np.random.RandomState(5).randint(0, 256, (len(t_all), 3, 16, 16), np.uint8)
    with h5py.File(data / "COCO16_val_test_xy.hdf5", "w") as f:
        f.create_dataset("imgs", data=imgs)
    for filt in (-1, 0):
        counts = []
        for name, mod in (("t", tcoco), ("j", jcoco)):
            out = tmp_path / f"gt_{name}_{filt}"
            argv = ["--set", "mode=\"store_gt\"", f"data_root=\"{data}\"", "resolution=16",
                    f"filter_hd={filt}", f"index_dir=\"{td}\"", f"out_path=\"{out}\""]
            counts.append((mod.main(argv), out))
        (nt, ot), (nj, oj) = counts
        assert nt == nj == (len(t_all) if filt < 0 else len(t_by[0]))
        assert sorted(os.listdir(ot)) == sorted(os.listdir(oj))
        for f in os.listdir(oj):
            assert (ot / f).read_bytes() == (oj / f).read_bytes()


def test_get_dataset_hdf5_filters_by_hamming_distance_as_jax(tmp_path):
    """``filter_hd`` through ``get_dataset_hdf5``: the index files under
    ``<data>/coco_stuff_val_indexes`` restrict the sampling indices as JAX's
    do, at distance 0 and 1."""
    rng = np.random.RandomState(3)
    names = jdata.hdf5_filenames(16, "coco", split="val", test_part=True)
    with h5py.File(tmp_path / names["xy"], "w") as f:
        f.create_dataset("imgs", data=rng.randint(0, 256, (10, 3, 16, 16), np.uint8))
        f.create_dataset("labels", data=np.zeros(10, np.int64))
    ids = list(range(100, 110))
    sets = [set(rng.choice(6, rng.randint(1, 4), replace=False).tolist()) for _ in ids]
    timg.build_hd_indexes(ids, sets, sets[:4] + [{0, 1, 2, 3, 4, 5}],
                          str(tmp_path / "coco_stuff_val_indexes"), device="cpu")
    kw = dict(resolution=16, data_path=str(tmp_path), which_dataset="coco", split="val",
              test_part=True, class_cond=False, instance_cond=False)
    for dist in (0, 1):
        t = tdata.get_dataset_hdf5(filter_hd=dist, **kw)
        j = jdata.get_dataset_hdf5(filter_hd=dist, **kw)
        np.testing.assert_array_equal(t.possible_sampling_idxs, j.possible_sampling_idxs)
        assert 0 < len(t) < 10


# --- the feature bank ------------------------------------------------------------------

def _blobs(n=256, d=32, k=8, seed=0):
    """``k`` well-separated Gaussian blobs, whose normalized rows lie about
    0.3 apart within a blob: both packages take squared distances as
    q² + b² − 2·q·b in float32, which for unit rows leaves an error of a few
    ulp of 2 in d², so radii agree to 1e-5 relative only from d² ≈ 0.05 up
    (at radii 0.07-0.1 they differ by up to 4e-5 relative, 3e-6 absolute)."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d) * 4
    return (centres[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)


def test_build_nns_and_kmeans_match_jax(tmp_path):
    """JAX's ``build_nns`` and ``build_kmeans`` on the port's feature file:
    indices and centres equal, radii 1e-5 relative; ``kmeans``' centroids
    and assignments against JAX's; one Lloyd step from the same centroids on
    random data, 1e-6 relative."""
    feats = _blobs()
    path = tmp_path / "feats.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("feats", data=feats)
    outs = {}
    for name, mod, kw in (("t", tprep, dict(device="cpu")), ("j", jprep, {})):
        nns, km = str(tmp_path / f"nns_{name}.hdf5"), str(tmp_path / f"km_{name}.npy")
        mod.build_nns(str(path), nns, k_nn=5, **kw)
        mod.build_kmeans(str(path), km, num_clusters=8, num_iters=20, **kw)
        with h5py.File(nns, "r") as f:
            outs[name] = (f["sample_nns"][:], f["sample_nns_radius"][:],
                          np.load(km, allow_pickle=True).item()["center_examples"])
    (ti, tr, tc), (ji, jr, jc) = outs["t"], outs["j"]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tr, jr, rtol=1e-5)
    assert tr.min() > 0.15
    # torch's index type; JAX's file holds int32 (ROADMAP.md §C).
    assert tc.shape == (8, 1) and tc.dtype == np.int64 and jc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    (tcent, tassign), (jcent, jassign) = (tbank.kmeans(feats, 8, 20, seed=3, device="cpu"),
                                          jbank.kmeans(feats, 8, 20, seed=3))
    np.testing.assert_allclose(tcent, jcent, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tassign, jassign)
    x = np.random.RandomState(4).randn(300, 16).astype(np.float32)
    c0 = x[:12] + 0.01
    tc1, ta1 = tbank._lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), 12, block=128)
    jc1, ja1 = jbank._lloyd_step(jnp.asarray(x), jnp.asarray(c0), 12)
    np.testing.assert_array_equal(ta1.numpy(), np.asarray(ja1))
    np.testing.assert_allclose(tc1.numpy(), np.asarray(jc1), rtol=1e-6, atol=1e-7)


# --- the slice as a whole --------------------------------------------------------------

RES, K_NN, K_MEANS = 32, 2, 2


def test_prepare_data_main_is_read_alike_by_both_packages(folder, tmp_path):
    """``prepare_data.main`` (the port's, ``--device cpu``) on a toy folder
    with a seeded ResNet-50 ``.pth``: the xy file bit for bit with JAX's
    ``iter_image_folder`` + ``build_xy_hdf5``; both feature banks against
    JAX's ResNet-50 on the same weights (1e-4 of each bank's largest value);
    the same bank without the flip; the k-NN file against JAX's ``build_nns``
    on it; moments of the right shape.  Both packages' ``get_dataset_hdf5``
    then read the folder alike: neighbours, radii, k-means samples and
    batches."""
    net = _random_resnet(6)
    pth = tmp_path / "rn50.pth"
    torch.save({"state_dict": net.state_dict()}, pth)
    out = tmp_path / "data"
    argv = ["--set", f"image_root=\"{folder}\"", f"out_path=\"{out}\"", f"resolution={RES}",
            f"k_nn={K_NN}", f"kmeans_subsampled={K_MEANS}",
            f"feature_extractor_weights=\"{pth}\"", "--device", "cpu"]
    tprep.main(argv)
    names = jdata.hdf5_filenames(RES, "imagenet", feature_extractor="selfsupervised", k_nn=K_NN)
    jxy = tmp_path / "jax_xy.hdf5"
    jprep.build_xy_hdf5(jprep.iter_image_folder(str(folder), RES), str(jxy))
    with h5py.File(out / names["xy"], "r") as t, h5py.File(jxy, "r") as j:
        for key in ("imgs", "labels"):
            assert t[key].dtype == j[key].dtype and t[key].chunks == j[key].chunks
            np.testing.assert_array_equal(t[key][:], j[key][:])
        imgs = t["imgs"][:]
    with h5py.File(out / names["feats"], "r") as f:
        banks = {k: f[k][:] for k in ("feats", "feats_hflip")}
    sd = torch.load(pth, weights_only=True)["state_dict"]
    variables = jresnet.load_torch_resnet50({k: v.numpy() for k, v in sd.items()})
    jnet = jresnet.ResNet50()
    fwd = cheap_jit(lambda v, x: jnet.apply(v, jresnet.preprocess(x))[0])
    x = np.transpose(imgs, (0, 2, 3, 1)).astype(np.float32) / 255.0
    for key, xs in (("feats", x), ("feats_hflip", x[:, :, ::-1])):
        want = np.asarray(fwd(variables, jnp.asarray(np.ascontiguousarray(xs))))
        assert banks[key].shape == want.shape == (6, 2048)
        assert np.abs(banks[key] - want).max() <= 1e-4 * np.abs(want).max(), key
    net = tprep.load_feature_extractor(str(pth), device="cpu")
    ((lo, hi, feats, flipped),) = tprep.iter_features(imgs[:2], net, hflip_bank=False)
    assert (lo, hi) == (0, 2) and flipped is None
    np.testing.assert_allclose(feats, banks["feats"][:2], rtol=0, atol=1e-6)
    jprep.build_nns(str(out / names["feats"]), str(tmp_path / "jax_nns.hdf5"), k_nn=K_NN)
    with h5py.File(out / names["nns"], "r") as t, h5py.File(tmp_path / "jax_nns.hdf5") as j:
        np.testing.assert_array_equal(t["sample_nns"][:], j["sample_nns"][:])
        # Random images give nearly parallel features (radii about 0.01):
        # the squared radii agree to the distance formula's float32
        # resolution, a few ulp of 2 (see _blobs).
        np.testing.assert_allclose(t["sample_nns_radius"][:] ** 2,
                                   j["sample_nns_radius"][:] ** 2, rtol=0, atol=1e-6)
    moments = np.load(out / "I32_inception_moments.npz")
    assert moments["mu"].shape == (2048,) and moments["sigma"].shape == (2048, 2048)
    assert np.isfinite(moments["sigma"]).all()

    kw = dict(resolution=RES, data_path=str(out), k_nn=K_NN, feature_extractor="selfsupervised",
              kmeans_subsampled=K_MEANS, class_cond=True, instance_cond=True, seed=4,
              feature_augmentation=True)
    jd, td = jdata.get_dataset_hdf5(**kw), tdata.get_dataset_hdf5(**kw, device="cpu")
    np.testing.assert_array_equal(td.sample_nns, jd.sample_nns)
    np.testing.assert_array_equal(td.sample_nn_radius, jd.sample_nn_radius)
    np.testing.assert_array_equal(td.kmeans_samples, jd.kmeans_samples)
    assert len(td.kmeans_samples) == K_MEANS
    for _ in range(2):
        tb, jb = td.sample_batch(4), jd.sample_batch(4)
        np.testing.assert_allclose(np.transpose(tb.images, (0, 2, 3, 1)), jb.images, atol=1e-6)
        for name in ("labels", "features", "radii"):
            np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)


# --- VGG16 and LPIPS -------------------------------------------------------------------

def _vgg(seed):
    """The port's VGG16 from a seed, with LPIPS weights off the ones."""
    net = tvgg.VGG16(device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for i, ch in enumerate(tvgg._TAP_CHANNELS):
            getattr(net, f"lin_{i}").copy_(torch.from_numpy(rng.uniform(-0.2, 1.0, ch)))
        for idx, _ in tvgg._CONV_PLAN:
            net.features[idx].bias.copy_(torch.from_numpy(0.05 * rng.randn(
                net.features[idx].bias.shape[0])))
    return net


def jax_vgg_variables(sd):
    """JAX VGG16 variables of a port state dict: the inverse of
    ``vgg_state_dict_from_jax``."""
    params = {}
    for key, t in sd.items():
        a = t.numpy()
        if key.startswith("features."):
            _, idx, leaf = key.split(".")
            params.setdefault(f"features_{idx}", {})[
                "kernel" if leaf == "weight" else "bias"] = (
                np.transpose(a, (2, 3, 1, 0)) if leaf == "weight" else a)
        else:
            params[key] = a
    return {"params": params}


@pytest.fixture(scope="module")
def vgg_pair():
    net = _vgg(0)
    variables = jax_vgg_variables(net.state_dict())
    sd = convert.vgg_state_dict_from_jax(variables)
    assert set(sd) == set(net.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())
    jnet = jvgg.VGG16()
    both = cheap_jit(lambda v, x, y: (
        jnet.apply(v, x, method=jnet.lpips_features),
        jnet.apply(v, x, y, method=jnet.lpips_distance)))
    return net, variables, both


@pytest.mark.parametrize("res", [32, 64])
def test_vgg16_lpips_matches_jax(vgg_pair, res):
    """LPIPS feature vectors (flattened in JAX's order) within 1e-4 of their
    largest entry, distances within 1e-4 relative, and the distance formula
    equal to the squared feature difference; raw taps as JAX's."""
    net, variables, both = vgg_pair
    rng = np.random.RandomState(res)
    x = rng.uniform(0, 255, (3, res, res, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 20, x.shape), 0, 255).astype(np.float32)
    jf, jd = (np.asarray(a) for a in both(variables, jnp.asarray(x), jnp.asarray(y)))
    tx, ty = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, y))
    with torch.no_grad():
        tf, td = net.lpips_features(tx).numpy(), net.lpips_distance(tx, ty).numpy()
        tfy = net.lpips_features(ty).numpy()
        taps = net.extract(tx)
    assert tf.shape == jf.shape and np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_allclose(((tf - tfy) ** 2).sum(1), td, rtol=1e-4)
    assert [tuple(t.shape[1:]) for t in taps] == [
        (c, res >> i, res >> i) for i, c in enumerate(tvgg._TAP_CHANNELS)]


def test_vgg16_loaders_match_jax(vgg_pair, tmp_path):
    """A torchvision state dict, a richzhang LPIPS checkpoint and a
    torchscript module built from a seed: the port's loaders give the
    parameters JAX's give (through ``vgg_state_dict_from_jax``)."""
    net = vgg_pair[0]
    sd = net.state_dict()
    tv = {k: v for k, v in sd.items() if k.startswith("features.")}
    tv["classifier.0.weight"] = torch.zeros(4, 3)
    torch.save(tv, tmp_path / "tv.pth")
    # richzhang: the trunk in slices (torchvision's indices kept), lin convs.
    slice_of = {0: 1, 2: 1, 5: 2, 7: 2, 10: 3, 12: 3, 14: 3, 17: 4, 19: 4, 21: 4, 24: 5,
                26: 5, 28: 5}
    rz = {f"net.slice{slice_of[int(k.split('.')[1])]}.{k.split('.', 1)[1]}": v
          for k, v in tv.items() if k.startswith("features.")}
    rz.update({f"lin{i}.model.1.weight": sd[f"lin_{i}"].reshape(1, -1, 1, 1)
               for i in range(5)})
    torch.save(rz, tmp_path / "rz.pth")

    class Scripted(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList(
                torch.nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in zip(
                    (3,) + tuple(c for _, c in tvgg._CONV_PLAN[:-1]),
                    tuple(c for _, c in tvgg._CONV_PLAN)))
            self.lins = torch.nn.ModuleList(torch.nn.Conv2d(c, 1, 1, bias=False)
                                            for c in tvgg._TAP_CHANNELS)

        def forward(self, x):
            return self.convs[0](x)

    m = Scripted()
    with torch.no_grad():
        for conv, (idx, _) in zip(m.convs, tvgg._CONV_PLAN):
            conv.weight.copy_(sd[f"features.{idx}.weight"])
            conv.bias.copy_(sd[f"features.{idx}.bias"])
        for i, lin in enumerate(m.lins):
            lin.weight.copy_(sd[f"lin_{i}"].reshape(1, -1, 1, 1))
    torch.jit.script(m).save(str(tmp_path / "ts.pt"))
    for name, lins in (("tv.pth", False), ("rz.pth", True), ("ts.pt", True)):
        got = tvgg.load_vgg16_file(str(tmp_path / name))
        want = convert.vgg_state_dict_from_jax(jvgg.load_vgg16_file(str(tmp_path / name)))
        assert set(got) == set(want) == set(sd), name
        for k in got:
            assert torch.equal(got[k], want[k]), (name, k)
        expect_lin = sd["lin_0"] if lins else torch.ones(64)
        assert torch.equal(got["lin_0"], expect_lin), name
        assert torch.equal(got["features.28.weight"], sd["features.28.weight"]), name


def test_lpips_feature_fn_runs_through_compute_ppl(vgg_pair, tmp_path, monkeypatch):
    """``make_lpips_feature_fn`` from a weights file (and from
    ``$ICGAN_VGG16_WEIGHTS``) in ``compute_ppl``: the PPL of the pairs'
    LPIPS distances (``LPIPSEvaluator.distance``) on the same draws; a
    synthesis that takes ``generator=`` draws one noise for both images of
    a pair, so that noise added to both leaves the distances."""
    net = vgg_pair[0]
    path = tmp_path / "vgg.pth"
    torch.save(net.state_dict(), path)
    ws_dim, res = 6, 32
    w = torch.from_numpy(np.random.RandomState(8).randn(ws_dim, 3 * res * res).astype(np.float32))

    def map_ws(z):
        return torch.tanh(z)[:, None, :]

    def synth(ws):
        return torch.tanh(ws.mean(1) @ w).reshape(-1, 3, res, res)

    def noisy_synth(ws, generator=None):
        return synth(ws) + 0.1 * torch.randn((ws.shape[0], 3, res, res), generator=generator)

    feature_fn = tmetrics.make_lpips_feature_fn(str(path), device="cpu")
    kw = dict(num_samples=6, batch=4, epsilon=0.05, sampling="full", seed=2, device="cpu")
    out = tmetrics.compute_ppl(synth, map_ws, ws_dim, feature_fn=feature_fn, **kw)
    assert out["ppl_distance"] == "lpips" and np.isfinite(out["ppl"]) and out["ppl"] > 0
    ev = tvgg.LPIPSEvaluator(str(path), device="cpu")
    assert ev.pretrained
    gen, dists = torch.Generator().manual_seed(2), []
    for b in (4, 2):
        z0, z1 = torch.randn((b, ws_dim), generator=gen), torch.randn((b, ws_dim), generator=gen)
        t = torch.rand((b, 1), generator=gen)
        w0, w1 = map_ws(z0), map_ws(z1)
        d = ev.distance(synth(w0 + (w1 - w0) * t[..., None]),
                        synth(w0 + (w1 - w0) * (t[..., None] + 0.05)))
        dists.append(d.double().numpy() / 0.05 ** 2)
    want = tmetrics.ppl_from_distances(np.concatenate(dists))
    assert abs(out["ppl"] - want) <= 1e-4 * want
    monkeypatch.setenv("ICGAN_VGG16_WEIGHTS", str(path))
    env_fn = tmetrics.make_lpips_feature_fn(device="cpu")
    pixel = dict(kw, sampling="end", num_samples=4)     # one batch: the same z on both
    for fn in (None, env_fn):
        clean = tmetrics.compute_ppl(synth, map_ws, ws_dim, feature_fn=fn, **pixel)["ppl"]
        noisy = tmetrics.compute_ppl(noisy_synth, map_ws, ws_dim, feature_fn=fn, **pixel)["ppl"]
        assert abs(noisy - clean) <= 1e-2 * clean if fn is None else np.isfinite(noisy)
