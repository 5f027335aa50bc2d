"""The port's inference front end (``cli/inference.py``, ``cli/generate_images.py``,
``cli/sample.py``, ``cli/demo.py``, ``models/resnet.py``) against the JAX
package's, on the CPU.

- ``load_generator`` from an upstream ``.pth`` bundle (written by the JAX
  package's exporter from random weights, with two best copies), BigGAN and
  BigGAN-deep, against JAX's ``load_generator`` on the same bundle: the same
  images for the same z; from a native checkpoint of the port's ``Trainer``;
  from a StyleGAN2 network pickle, also by the ``best-network-snapshot.pkl``
  convention.
- The conditioning draws (``get_conditionings``, ``make_conditioned_sampler``
  in both balance modes on one toy HDF5 set) against JAX's, exactly.
- ResNet-50 and ``preprocess`` against JAX's; the checkpoint prefixes.
- The three CLIs end to end on a toy model with ``--device cpu``, and the
  demo's ranking: the port ranks with the network that took the target's
  features; the JAX demo ranks with a fresh one (ROADMAP.md §C).

JAX's networks are never initialized (``init`` compiles for tens of
seconds here): their variables come from the port's through the inverse of
the key maps.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ic_gan_tpu.cli import demo as jdemo
from ic_gan_tpu.cli import inference as jinf
from ic_gan_tpu.data import datasets as jdata
from ic_gan_tpu.data import feature_bank as jbank
from ic_gan_tpu.io import deploy as jdeploy
from ic_gan_tpu.io import torch_import as jimport
from ic_gan_tpu.models import resnet as jresnet
from ic_gan_tpu_torch.cli import demo as tdemo
from ic_gan_tpu_torch.cli import generate_images as tgen
from ic_gan_tpu_torch.cli import inference as tinf
from ic_gan_tpu_torch.cli import sample as tsample
from ic_gan_tpu_torch.cli.config import split_config
from ic_gan_tpu_torch.data import datasets as tdata
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.io import stylegan_import as tsg2_import
from ic_gan_tpu_torch.models import biggan_deep as tdeep
from ic_gan_tpu_torch.models import resnet as tresnet
from ic_gan_tpu_torch.models import stylegan2 as tsg2
from ic_gan_tpu_torch.train import trainer as ttrainer
from test_torch_port_biggan_deep import _perturb, jax_variables
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401
from test_torch_port_sg2_import import tf_pickle  # noqa: F401

h5py = pytest.importorskip("h5py")

# Toy models, as flat configs a user would write: res 32, ch 8, attention at
# 16², 2048-d instance features; BigGAN with hier z chunks, BigGAN-deep with
# classes too.
BIGGAN = dict(resolution=32, G_ch=8, D_ch=8, G_attn="16", D_attn="16", hier=True,
              instance_cond=True, G_shared_feat=True, shared_dim_feat=16, dim_z=20)
DEEP = dict(BIGGAN, model="BigGANdeep", class_cond=True, n_classes=10, shared_dim=16)
N_DATA, K, IMG_ATOL = 24, 3, 1e-5


def _model(flat, seed):
    """The port's G for a flat config, from a seed, perturbed off its init."""
    cfg = split_config(flat)[0]
    cls = tdeep.model_classes(cfg)[0]
    return cfg, _perturb(cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)),
                         seed)


def _key_map(cfg):
    deep = isinstance(cfg, tdeep.BigGANDeepConfig)
    return convert.deep_generator_key_map(cfg) if deep else convert.generator_key_map(cfg)


def _jax_cfg(cfg):
    """The JAX package's config of the same model (its ``split_config``)."""
    from ic_gan_tpu.cli.config import split_config as jsplit

    return jsplit(cfg)[0]


def write_bundle(root, flat, seed=0):
    """An upstream ``.pth`` bundle of the model ``flat`` configures, written
    by the JAX package's exporter from the port's random weights: ``G_ema``
    of two best copies (best1 of the lower FID) and of the main one, each
    with its ``state_dict`` blob, and the main one's ``D``.  Returns the
    best1 generator."""
    os.makedirs(root, exist_ok=True)
    deep = flat.get("model") == "BigGANdeep"
    for i, (suffix, fid) in enumerate((("best0", 9.0), ("best1", 4.0), ("", None))):
        cfg, g = _model(flat, seed + i)
        variables = jax_variables(g.state_dict(), _key_map(cfg))
        sd = jimport.export_generator_state_dict(variables, _jax_cfg(flat), deep=deep)
        tag = f"_{suffix}" if suffix else ""
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   os.path.join(root, f"G_ema{tag}.pth"))
        blob = {"config": dict(flat)}
        if fid is not None:
            blob["best_FID"] = fid
        torch.save(blob, os.path.join(root, f"state_dict{tag}.pth"))
        if suffix == "best1":
            best = g
    cls = tdeep.model_classes(cfg)[1]
    d = _perturb(cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)), seed)
    key_map = (convert.deep_discriminator_key_map(cfg) if deep
               else convert.discriminator_key_map(cfg))
    sd = jimport.export_discriminator_state_dict(jax_variables(d.state_dict(), key_map),
                                                 _jax_cfg(flat), deep=deep)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(root, "D.pth"))
    return best


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundles")
    return {name: (str(root / name), flat, write_bundle(str(root / name), flat))
            for name, flat in (("biggan", BIGGAN), ("deep", DEEP))}


def _z_and_conditioning(cfg, n=3, seed=1):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, cfg.effective_dim_z).astype(np.float32)
    label = rng.randint(0, cfg.n_classes, n) if cfg.class_cond else None
    feats = rng.randn(n, cfg.instance_sz).astype(np.float32)
    return z, label, feats


@pytest.mark.parametrize("name", ["biggan", "deep"])
def test_load_generator_from_pth_matches_jax(bundles, name):
    """The best1 copy (the lower FID) of the bundle through both packages'
    ``load_generator``, folded, f32: the same images for the same z, to
    1e-5; and the weights the port loaded are that copy's."""
    pth_dir, flat, best = bundles[name]
    cfg = dict(flat, pth_dir=pth_dir, batch_size=2)
    sampler, model_cfg = tinf.load_model_inference(cfg, device="cpu")
    assert type(model_cfg).__name__ == ("BigGANDeepConfig" if name == "deep" else "BigGANConfig")
    jg, jvars, jcfg = jinf.load_generator(dict(cfg))
    assert type(jcfg).__name__ == type(model_cfg).__name__
    z, label, feats = _z_and_conditioning(model_cfg)
    got = sampler(z, label, feats)                 # 3 images in batches of 2
    apply = cheap_jit(lambda v, z, lab, f: jg.apply(v, z, lab, f, train=False))
    want = np.asarray(apply(jdeploy.fold_spectral_norm(jvars), jnp.asarray(z),
                            None if label is None else jnp.asarray(label), jnp.asarray(feats)))
    assert got.shape == want.shape == (3, 32, 32, 3) and want.std() > 1e-2
    assert np.abs(got - want).max() <= IMG_ATOL
    with torch.no_grad():
        direct = best.eval()(torch.from_numpy(z), None if label is None else
                             torch.from_numpy(label), torch.from_numpy(feats))
    assert np.abs(got - direct.permute(0, 2, 3, 1).numpy()).max() <= IMG_ATOL
    # No suffix given: best1; an explicit one is taken as it is.
    other, _ = tinf.load_generator(dict(cfg, suffix="best0"), device="cpu")
    assert not torch.equal(other.linear.weight, sampler.module.linear.weight)


def test_pth_config_blob_of_a_deep_bundle_asks_for_its_config(bundles):
    """The repair: a BigGAN-deep blob no longer builds a BigGAN G and fails
    far away; it names the model and asks for ``cfg``.  With it, G and D
    load (D with upstream's names, as the JAX exporter writes them)."""
    from ic_gan_tpu_torch.io.torch_import import (
        load_discriminator_from_pth,
        load_generator_from_pth,
    )

    pth_dir = bundles["deep"][0]
    with pytest.raises(ValueError, match="model: BigGANdeep.*cfg"):
        load_generator_from_pth(pth_dir, "G_ema", "best1", device="cpu")
    cfg = split_config(DEEP)[0]
    g, missing, unexpected = load_generator_from_pth(pth_dir, "G_ema", "best1", cfg=cfg,
                                                     device="cpu")
    assert isinstance(g, tdeep.Generator) and missing == unexpected == []
    d, missing, unexpected = load_discriminator_from_pth(pth_dir, cfg=cfg, device="cpu")
    saved = torch.load(os.path.join(pth_dir, "D.pth"), weights_only=True)
    assert isinstance(d, tdeep.Discriminator) and missing == unexpected == []
    assert all(torch.equal(v, saved[k]) for k, v in d.state_dict().items())


class _Dataset:
    """The dataset surface the trainer reads, 12 samples from a seed."""

    which_nn_balance = "instance_balance"

    def __init__(self, cfg):
        from ic_gan_tpu_torch.data.datasets import Batch

        self.batch = Batch
        gen = torch.Generator().manual_seed(0)
        self.images = torch.rand((12, 3, cfg.resolution, cfg.resolution), generator=gen) * 2 - 1
        self.feats = torch.randn((12, cfg.instance_sz), generator=gen)
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return 12

    def sample_batch(self, n, weights=None):
        i = self.rng.integers(0, 12, n)
        return self.batch(self.images[i], None, self.feats[i], None)

    def sample_conditioning_instance_balance(self, n, weights=None):
        return None, self.feats[self.rng.integers(0, 12, n)]


def test_load_generator_from_native_checkpoint(tmp_path):
    """A checkpoint the port's ``Trainer`` saved: without ``load_weights``
    the best copy of lowest recorded FID, the EMA G unless ``use_ema`` is
    false; a named copy with it; the main checkpoint when there is no best
    copy."""
    flat = dict(BIGGAN, experiment_name="native", weights_root=str(tmp_path), batch_size=2,
                num_D_steps=1, ema=True, ema_start=0, no_tb=True, num_epochs=1,
                logs_root=str(tmp_path / "l"))
    model_cfg, train_cfg, trainer_cfg, _ = split_config(flat)
    tr = ttrainer.Trainer(model_cfg, train_cfg, trainer_cfg, _Dataset(model_cfg), device="cpu")
    tr.run(steps_per_epoch=1)                   # the main checkpoint and copy0
    for i, suffix in ((1, "best0"), (2, "")):   # one step on, best0; one more, the main one
        tr.state, _ = tr.step_fn(tr.state, tr.make_batch(), tr.step_generator(i))
        tr.history["best_FID"] = 5.0
        tr.save(suffix=suffix)

    def same(g, saved):
        return all(torch.equal(v, saved[k]) for k, v in g.state_dict().items())

    best = torch.load(tmp_path / "native_best0" / "state.pt", weights_only=True)
    g, cfg = tinf.load_generator(flat, device="cpu")
    assert cfg == model_cfg and not g.training and same(g, best["g_ema"])
    assert same(tinf.load_generator(dict(flat, use_ema=False), device="cpu")[0], best["g"])
    copy0 = torch.load(tmp_path / "native_copy0" / "state.pt", weights_only=True)
    assert same(tinf.load_generator(dict(flat, load_weights="copy0"), device="cpu")[0],
                copy0["g_ema"])
    assert not same(g, copy0["g_ema"])
    shutil.rmtree(tmp_path / "native_best0")
    assert same(tinf.load_generator(flat, device="cpu")[0], tr.state.g_ema.state_dict())


def test_load_generator_from_stylegan2_pickle(tf_pickle, tmp_path):  # noqa: F811
    """A network pickle, named or by the ``best-network-snapshot.pkl``
    convention: the G_ema state dict the importer converts, in a G built
    from its init kwargs; behind ``load_model_inference`` with constant
    noise, the direct call's images."""
    sd, kw = tsg2_import.load_network_pkl(tf_pickle)["G_ema"]
    g, cfg = tinf.load_generator(dict(backbone="stylegan2", network_pkl=tf_pickle), device="cpu")
    assert isinstance(g, tsg2.Generator) and cfg.img_resolution == kw["img_resolution"]
    assert all(torch.equal(v, sd[k]) for k, v in g.state_dict().items())
    os.makedirs(tmp_path / "exp")
    shutil.copy(tf_pickle, tmp_path / "exp" / "best-network-snapshot.pkl")
    flat = dict(backbone="stylegan2", base_root=str(tmp_path), experiment_name="exp",
                truncation_psi=0.7, batch_size=2)
    sampler, cfg2 = tinf.load_model_inference(flat, device="cpu")
    assert cfg2 == cfg
    z = torch.from_numpy(np.random.RandomState(0).randn(3, cfg.z_dim).astype(np.float32))
    got = sampler(z)
    with torch.no_grad():
        want = g(z, truncation_psi=0.7, noise_mode="const").permute(0, 2, 3, 1).numpy()
    assert got.shape == (3, cfg.img_resolution, cfg.img_resolution, 3)
    assert np.abs(got - want).max() <= IMG_ATOL
    with pytest.raises(ValueError, match="network_pkl"):
        tinf.load_generator(dict(backbone="stylegan2"), device="cpu")
    with pytest.raises(NotImplementedError, match="A.15"):
        tinf.load_model_inference(dict(flat, quantize_serving=True), device="cpu")


# --- conditioning draws ----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(index=2), dict(swap_target=7), dict(z_var=0.25)])
def test_get_conditionings_match_jax(kw):
    """Instances, labels and feature rows exactly as JAX's; z of the shape
    and the scale asked for (a torch stream, not JAX's)."""
    rng = np.random.RandomState(0)
    feats, labels = rng.randn(6, 8).astype(np.float32), rng.randint(0, 5, 6)
    args = (4, 3, feats, labels, 16)
    jz, jl, jf, ji = jinf.get_conditionings(*args, seed=3, **kw)
    tz, tl, tf, ti = tinf.get_conditionings(*args, seed=3, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert tz.shape == jz.shape == (12, 16) and tz.dtype == torch.float32
    assert torch.equal(tz, tinf.get_conditionings(*args, seed=3, **kw)[0])
    big = tinf.get_conditionings(100, 100, np.repeat(feats, 20, 0), None, 16, seed=3, **kw)[0]
    assert abs(big.var().item() - kw.get("z_var", 1.0)) < 0.03 * kw.get("z_var", 1.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """24 images at 32² with labels in 5 classes, 2048-d features and their
    k-NN file, under the reference's file names."""
    root = tmp_path_factory.mktemp("hdf5")
    rng = np.random.RandomState(0)
    names = jdata.hdf5_filenames(32, "imagenet", feature_extractor="classification", k_nn=K)
    feats = rng.randn(N_DATA, 2048).astype(np.float32)
    with h5py.File(root / names["xy"], "w") as f:
        f.create_dataset("imgs", data=rng.randint(0, 256, (N_DATA, 3, 32, 32), dtype=np.uint8))
        f.create_dataset("labels", data=np.arange(N_DATA) % 5)
    with h5py.File(root / names["feats"], "w") as f:
        f.create_dataset("feats", data=feats)
    idx, radii = jbank.knn(feats / np.linalg.norm(feats, axis=1, keepdims=True), K + 1)
    with h5py.File(root / names["nns"], "w") as f:
        f.create_dataset("sample_nns", data=idx)
        f.create_dataset("sample_nns_radius", data=radii)
    return root


@pytest.mark.parametrize("balance", ["instance_balance", "nnclass_balance"])
def test_conditioned_sampler_draws_match_jax(files, balance):
    """``make_conditioned_sampler`` of a class-and-instance model over the
    same HDF5 set in both packages: three draws of labels and features,
    exactly; z of the shape and scale asked for."""
    flat = dict(DEEP, n_classes=5, data_root=str(files), k_nn=K, which_knn_balance=balance,
                feature_extractor="classification", z_var=0.5, seed=4)
    model_cfg = split_config(flat)[0]
    kw = split_config(flat)[3]

    class Apply:
        module = torch.nn.Linear(1, 1)

    jsample = jinf.make_conditioned_sampler(flat, None, _jax_cfg(flat),
                                            jdata.get_dataset_hdf5(**kw))
    tsample_ = tinf.make_conditioned_sampler(flat, Apply(), model_cfg,
                                             tdata.get_dataset_hdf5(**kw))
    for b in (4, 7, 1):
        jz, jl, jf, jlabels = jsample.draw(b)
        tz, tl, tf, tlabels = tsample_.draw(b)
        np.testing.assert_array_equal(tlabels, jlabels)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert tz.shape == jz.shape == (b, model_cfg.effective_dim_z)
    z = tsample_.draw(2000)[0]
    assert abs(z.var().item() - 0.5) < 0.02


# --- ResNet-50 -------------------------------------------------------------------

def _jax_resnet_variables(net):
    """The JAX ResNet-50 variables of the port's, by the inverse of
    ``resnet_state_dict_from_jax``."""
    tree = {}
    for key, t in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        *mods, leaf = key.split(".")
        if mods[0].startswith("layer"):
            sub = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(
                ".".join(mods[2:]), mods[2])
            path = (f"{mods[0]}_{mods[1]}", sub)
        else:
            path = (mods[0],)
        a = t.numpy()
        if leaf == "weight" and a.ndim == 4:
            leaf, a = "kernel", np.transpose(a, (2, 3, 1, 0))
        elif path == ("fc",):
            leaf, a = {"weight": "kernel", "bias": "bias"}[leaf], (a.T if a.ndim == 2 else a)
        else:
            leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                    "running_var": "var"}[leaf]
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return {"params": tree}


def _random_resnet(seed, classifier=False):
    """The port's ResNet-50 from a seed with batch norm off the identity."""
    net = tresnet.ResNet50(classifier=classifier, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tresnet.FrozenBatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.0, c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.randn(c)))
        if classifier:
            net.fc.weight.normal_(0, 0.02, generator=torch.Generator().manual_seed(seed))
    return net


def test_resnet50_matches_jax():
    """Logits, conv features and pooled features at 64², batch 2, against
    the JAX ResNet-50 on the same weights, 1e-4 of each output's largest
    entry (f32, 53 convs); the converter is the state dict's exact inverse."""
    net = _random_resnet(0, classifier=True)
    variables = _jax_resnet_variables(net)
    sd = convert.resnet_state_dict_from_jax(variables)
    want_keys = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want_keys
    assert all(torch.equal(sd[k], net.state_dict()[k]) for k in sd)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jnet = jresnet.ResNet50(classifier=True)
    logits, conv = cheap_jit(lambda v, x: jnet.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got_logits, got_conv = net(torch.from_numpy(x).permute(0, 3, 1, 2))
        plain = tresnet.load_torch_resnet50(net.state_dict(), device="cpu")
        pooled, _ = plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    conv = np.asarray(conv)
    for got, want in ((got_logits.numpy(), np.asarray(logits)),
                      (got_conv.permute(0, 2, 3, 1).numpy(), conv),
                      (pooled.numpy(), conv.mean(axis=(1, 2)))):
        assert got.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("size", [256, 64, 300])
def test_preprocess_matches_jax(size):
    """The bicubic resize to 224² and the normalization against
    ``jax.image.resize``'s antialiased Keys cubic: atol 2e-5 in the input's
    units (pixels in [0, 1]), so 2e-5/std of a channel on the normalized
    output (the two resizes' f32 weights differ by up to 1e-5 of a pixel at
    300→224; the normalization divides by std ≥ 0.224)."""
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jresnet.preprocess(jnp.asarray(x)))
    got = tresnet.preprocess(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 224, 224, 3)
    std = np.asarray(tresnet.IMAGENET_STD, np.float32)
    assert np.abs((got.numpy() - want) * std).max() <= 2e-5
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=224,
                                            mode="bicubic", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want * std
                  - np.asarray(tresnet.IMAGENET_MEAN)).max() > 1e-2   # the obvious resize is off


def test_load_torch_resnet50_strips_prefixes():
    """SwAV (``module._feature_blocks.`` and a projection head) and DDP
    (``module.``) checkpoints load into the trunk; ``fc`` only with
    ``classifier``; a missing trunk key raises."""
    net = _random_resnet(2, classifier=True)
    sd = net.state_dict()
    swav = {f"module._feature_blocks.{k}": v for k, v in sd.items() if not k.startswith("fc.")}
    swav["module.projection_head.0.weight"] = torch.zeros(3, 3)
    swav["module.prototypes.weight"] = torch.zeros(3, 3)
    trunk = tresnet.load_torch_resnet50(swav, device="cpu")
    assert not hasattr(trunk, "fc")
    assert all(torch.equal(v, sd[k]) for k, v in trunk.state_dict().items())
    ddp = tresnet.load_torch_resnet50({f"module.{k}": v for k, v in sd.items()},
                                      classifier=True, device="cpu")
    assert torch.equal(ddp.fc.weight, sd["fc.weight"])
    with pytest.raises(KeyError, match="layer4.2.conv3.weight"):
        tresnet.load_torch_resnet50({k: v for k, v in sd.items() if k != "layer4.2.conv3.weight"},
                                    device="cpu")


# --- the CLIs ---------------------------------------------------------------------

def _stored(tmp_path, n=4, feat_dim=2048, images=True):
    """A stored-instances npy: features, labels and ground-truth image paths
    (PNGs of 40×30 under ``tmp_path/data``)."""
    from PIL import Image

    rng = np.random.RandomState(5)
    paths = []
    if images:
        os.makedirs(tmp_path / "data", exist_ok=True)
        for i in range(n):
            p = f"img{i}.png"
            Image.fromarray(rng.randint(0, 256, (30, 40, 3), dtype=np.uint8)).save(
                tmp_path / "data" / p)
            paths.append(p)
    stored = dict(instance_features=rng.randn(n, feat_dim).astype(np.float32),
                  labels=rng.randint(0, 10, n), image_path=np.asarray(paths))
    path = tmp_path / "stored.npy"
    np.save(path, stored, allow_pickle=True)
    return str(path)


def test_generate_images_cli(bundles, tmp_path):
    """``cli/generate_images.py --device cpu`` on the deep bundle: a
    row-major grid, one row a conditioning, ``num_imgs_gen`` columns; with
    ``visualize_instance_images`` the ground truth and a 20-pixel gutter in
    front; rows equal to the sampler on ``get_conditionings``'s draws."""
    from PIL import Image

    pth_dir, flat, _ = bundles["deep"]
    stored = _stored(tmp_path)
    cfg = dict(flat, pth_dir=pth_dir, stored_features=stored, num_conditionings_gen=3,
               num_imgs_gen=2, out_path=str(tmp_path / "out" / "grid.png"), seed=2, batch_size=4)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    argv = ["--json_config", str(tmp_path / "cfg.json"), "--device", "cpu"]
    out = tgen.main(argv)
    grid = np.asarray(Image.open(out))
    assert grid.shape == (3 * 32, 2 * 32, 3)
    sampler, model_cfg = tinf.load_model_inference(cfg, device="cpu")
    feats, labels, _ = tinf.load_stored_instances(stored)
    z, lab, f, idxs = tinf.get_conditionings(3, 2, feats, labels, model_cfg.effective_dim_z,
                                             seed=2)
    imgs = tgen.to_uint8(sampler(z, lab, f))
    assert np.array_equal(grid[32:64, 32:64], imgs[3])             # row 1, column 1
    out2 = tgen.main(argv + ["--set", "visualize_instance_images=true",
                             f"dataset_path={tmp_path / 'data'}", "index=1"])
    grid2 = np.asarray(Image.open(out2))
    assert grid2.shape == (3 * 32, 32 + 20 + 2 * 32, 3)
    assert (grid2[:, 32:52] == 255).all()
    gt = Image.open(tmp_path / "data" / "img1.png").convert("RGB").crop((5, 0, 35, 30))
    assert np.array_equal(grid2[:32, :32], np.asarray(gt.resize((32, 32), Image.BILINEAR)))
    z, lab, f, idxs = tinf.get_conditionings(3, 2, feats, labels, model_cfg.effective_dim_z,
                                             seed=2, index=1)
    assert list(idxs) == [1, 1, 1]
    pinned = tgen.to_uint8(sampler(z, lab, f))
    assert np.array_equal(grid2[64:96, 52 + 32:], pinned[5])       # row 2, column 1


def test_sample_cli(bundles, files, tmp_path):
    """``cli/sample.py --device cpu`` on the BigGAN bundle, conditioned on
    the toy HDF5 set: ``num_imgs`` JPEGs of the model's resolution."""
    from PIL import Image

    pth_dir, flat, _ = bundles["biggan"]
    out = tmp_path / "samples"
    tsample.main(["--set", f"pth_dir={json.dumps(pth_dir)}", f"data_root={json.dumps(str(files))}",
                  f"k_nn={K}", "num_imgs=5", "batch_size=2", f"out_dir={json.dumps(str(out))}",
                  *[f"{k}={json.dumps(v)}" for k, v in flat.items()], "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == [f"{i:06d}.jpg" for i in range(5)]
    assert Image.open(out / names[0]).size == (32, 32)


def test_demo_ranks_with_the_loaded_extractor(bundles, tmp_path, monkeypatch):
    """``cli/demo.py --device cpu`` with ``feature_extractor_weights``: the
    grid is the samples in the order of their cosine similarity to the
    input's features, both taken by the loaded network.  The JAX demo, on the
    same images, ranks with a freshly initialized ResNet-50 instead
    (ROADMAP.md §C): its ranking network holds other weights, and its order
    is not the loaded network's."""
    from PIL import Image

    pth_dir, flat, _ = bundles["biggan"]
    net = _random_resnet(3)
    torch.save({"state_dict": {f"module.{k}": v for k, v in net.state_dict().items()}},
               tmp_path / "rn50.pth")
    Image.fromarray(np.random.RandomState(6).randint(0, 256, (48, 64, 3), dtype=np.uint8)).save(
        tmp_path / "in.png")
    n = 4
    cfg = dict(flat, pth_dir=pth_dir, input_image=str(tmp_path / "in.png"), num_samples=n,
               feature_extractor_weights=str(tmp_path / "rn50.pth"),
               out_path=str(tmp_path / "var.png"), seed=1, batch_size=n)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    out, order = tdemo.main(["--json_config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    grid = np.asarray(Image.open(out))
    assert grid.shape == (2 * 32, 2 * 32, 3)

    # The same samples and target, ranked here with the loaded network.
    sampler, model_cfg = tinf.load_model_inference(cfg, device="cpu")
    target = tdemo.extract_features(str(tmp_path / "in.png"), net)
    z = torch.randn((n, model_cfg.effective_dim_z), generator=torch.Generator().manual_seed(1))
    imgs = sampler(z, None, np.repeat(target[None], n, axis=0))
    sims = tdemo.features(net, (torch.from_numpy(imgs).permute(0, 3, 1, 2) + 1) / 2) @ \
        torch.from_numpy(target)
    want = np.argsort(-sims.numpy(), kind="stable")
    assert np.array_equal(order, want) and np.diff(np.sort(sims.numpy())).min() > 1e-6
    cell = lambda i: grid[(i // 2) * 32:(i // 2 + 1) * 32, (i % 2) * 32:(i % 2 + 1) * 32]  # noqa: E731
    ordered = (np.clip((imgs[want] + 1) / 2, 0, 1) * 255).astype(np.uint8)
    assert all(np.array_equal(cell(i), ordered[i]) for i in range(n))

    # The JAX demo on the same images and weights.  Its ResNet-50 runs as
    # the port's on the weights each call is given (the two agree:
    # test_resnet50_matches_jax); its fresh init is a seeded draw of the
    # same shapes.  Recorded: the weights of each call.
    calls, shown = [], {}

    def apply(self, variables, x):
        calls.append(variables)
        ported = tresnet.load_torch_resnet50(convert.resnet_state_dict_from_jax(variables),
                                             device="cpu")
        with torch.no_grad():
            pooled, _ = ported(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
        return jnp.asarray(pooled.numpy()), None

    class Cfg:
        effective_dim_z = model_cfg.effective_dim_z

    monkeypatch.setattr(jresnet.ResNet50, "apply", apply)
    monkeypatch.setattr(jresnet.ResNet50, "init",
                        lambda self, *a, **k: _jax_resnet_variables(_random_resnet(7)))
    monkeypatch.setattr(jdemo, "load_model_inference", lambda c: ((lambda z, l, f: imgs), Cfg()))
    monkeypatch.setattr(jdemo, "save_image_grid",
                        lambda images, path, nrow: shown.setdefault("images", images))
    jdemo.main(["--json_config", str(tmp_path / "cfg.json")])
    loaded, ranking = calls[0]["params"], calls[1]["params"]
    assert np.array_equal(loaded["conv1"]["kernel"], np.transpose(
        net.conv1.weight.detach().numpy(), (2, 3, 1, 0)))
    assert not np.array_equal(ranking["conv1"]["kernel"], loaded["conv1"]["kernel"])
    jax_order = [next(i for i in range(n) if np.array_equal(shown["images"][j], imgs[i]))
                 for j in range(n)]
    assert not np.array_equal(jax_order, want)
