"""The port's pretrained-weight paths that need no TensorFlow: the TFHub
BigGAN importer (``io/tfhub_import.py``, ``cli/convert_tfhub.py``) and the
official TF1 Inception (``eval/tf_inception.py``, ``cli/official_eval.py``)
against the JAX package's, on the CPU.

- TFHub: synthetic variable dumps with the release's names and shapes at
  toy width (``tests/test_tfhub_import.py:_make_dump``):
  ``convert_tfhub_dump`` array for array, exactly, with and without EMA;
  ``load_tfhub_generator``'s forward against JAX's G on the same dump at
  1e-4 in float32; the CLI's native checkpoint, ``.pth`` and bf16 sample
  grid.
- TF1: the executor against JAX's on the JAX test's mini graph
  (``tests/test_tf_inception.py:_mini_graph``) and on a graph that runs
  every op the executor handles, at 1e-4; ``OfficialTF1Evaluator``,
  ``evaluate_images`` and ``official_inception_score``; every path of
  ``cli/official_eval.py`` (an npz and a pickle of samples, the
  ground-truth HDF5 with ImageNet-LT strata, ``fid_a``/``fid_b``) against
  JAX's CLI on the same files.
- Each new entry point raises without a card unless given the CPU.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from torch.nn.utils import skip_init

import jax
import jax.numpy as jnp

import ic_gan_tpu.io.tfhub_import as jtfhub
import ic_gan_tpu_torch.io.tfhub_import as ttfhub
from ic_gan_tpu.cli import official_eval as jofficial
from ic_gan_tpu.eval import tf_inception as jtf
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu_torch.cli import convert_tfhub as tconvert
from ic_gan_tpu_torch.cli import official_eval as tofficial
from ic_gan_tpu_torch.eval import tf_inception as ttf
from ic_gan_tpu_torch.io.checkpoint import load_checkpoint
from ic_gan_tpu_torch.io.deploy import make_sampler
from ic_gan_tpu_torch.io.graphdef import encode_graphdef, encode_node, parse_graphdef
from ic_gan_tpu_torch.io.torch_import import load_generator_state_dict
from ic_gan_tpu_torch.models.biggan import Generator
from test_tf_inception import _mini_graph
from test_tfhub_import import _make_dump
from test_torch_port_classcond import _one_torch_thread, cheap_jit, in_background  # noqa: F401

h5py = pytest.importorskip("h5py")
ATOL = 1e-4


@pytest.fixture
def toy_width(monkeypatch):
    """Both importers at G_ch 8."""
    monkeypatch.setattr(jtfhub, "_CH", 8)
    monkeypatch.setattr(ttfhub, "_CH", 8)


# --- TFHub ------------------------------------------------------------------------

@pytest.mark.parametrize("ema", [True, False])
def test_convert_tfhub_dump_equals_jax(toy_width, ema):
    """The one-hop conversion, array for array and bit for bit, reading the
    EMA names or the raw ones."""
    dump, _ = _make_dump(128, 8, np.random.RandomState(0), ema=ema)
    want = jtfhub.convert_tfhub_dump(dump, 128, load_ema=ema)
    got = ttfhub.convert_tfhub_dump(dump, 128, load_ema=ema)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_load_tfhub_generator_matches_jax(toy_width, tmp_path):
    """The dump as the port's G and as JAX's variables, σ synthesized from
    the weights on both sides: the same images for the same z and classes
    at 1e-4, eval mode, f32; every buffer of the port's G filled; an
    ``.npz`` of the dump loads the same G."""
    dump, _ = _make_dump(128, 8, np.random.RandomState(2))
    rng = np.random.RandomState(3)
    jvars, jcfg = jtfhub.load_tfhub_generator(dump, 128)
    z = rng.randn(2, jcfg.effective_dim_z).astype(np.float32)
    y = np.asarray([3, 500], np.int32)
    jg = jbiggan.Generator(jcfg)
    want = in_background(lambda: np.asarray(cheap_jit(
        lambda v, z, y: jg.apply(v, z, y, None, train=False))(jvars, jnp.asarray(z),
                                                              jnp.asarray(y))))
    g, cfg = ttfhub.load_tfhub_generator(dump, 128, device="cpu")
    assert cfg.G_ch == 8 and cfg.class_cond and not cfg.instance_cond and not g.training
    sd = ttfhub.convert_tfhub_dump(dump, 128)
    assert "linear.sv0" not in sd and "linear.sv0" in g.state_dict()   # synthesized
    with torch.no_grad():
        got = g(torch.from_numpy(z), torch.from_numpy(y).long()).permute(0, 2, 3, 1).numpy()
    want = want.result()
    assert got.shape == want.shape == (2, 128, 128, 3) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.savez(tmp_path / "dump.npz", **dump)
    again, _ = ttfhub.load_tfhub_generator(str(tmp_path / "dump.npz"), 128, device="cpu")
    assert all(torch.equal(v, g.state_dict()[k]) for k, v in again.state_dict().items())


def test_convert_tfhub_cli(toy_width, tmp_path):
    """The CLI from an HDF5 dump: the native checkpoint reloads bit for bit,
    the ``.pth`` loads into a G of the same weights, and the sample grid is
    the folded bf16 G's images of the CLI's draws."""
    dump, _ = _make_dump(128, 8, np.random.RandomState(4))
    h5_path = tmp_path / "biggan-128.h5"
    with h5py.File(h5_path, "w") as f:
        for k, v in dump.items():
            f.create_dataset(k, data=v)
    out, pth, grid = tmp_path / "native" / "tfhub128", tmp_path / "g.pth", tmp_path / "s.png"
    g, cfg = tconvert.main(["--set", f"dump={h5_path}", "resolution=128", f"out={out}",
                            f"pth_out={pth}", f"sample_grid={grid}", "sample_batch=4",
                            "--device", "cpu"])
    direct, _ = ttfhub.load_tfhub_generator(dump, 128, device="cpu")
    assert all(torch.equal(v, direct.state_dict()[k]) for k, v in g.state_dict().items())
    state, config = load_checkpoint(str(out.parent), out.name,
                                    tconvert.GeneratorState(skip_init(Generator, cfg)))
    assert config["G_ch"] == 8 and config["resolution"] == 128
    assert all(torch.equal(v, g.state_dict()[k]) for k, v in state.g.state_dict().items())
    again, missing, unexpected = load_generator_state_dict(torch.load(pth), cfg, device="cpu")
    assert missing == unexpected == []
    assert all(torch.equal(v, g.state_dict()[k]) for k, v in again.state_dict().items())
    from PIL import Image

    from ic_gan_tpu_torch.cli.inference import save_image_grid
    from ic_gan_tpu_torch.io.deploy import cast_params, fold_spectral_norm, set_compute_dtype

    folded = cast_params(fold_spectral_norm(set_compute_dtype(again, torch.bfloat16)))
    z = torch.randn((4, cfg.effective_dim_z), generator=torch.Generator().manual_seed(0))
    imgs = make_sampler(folded, batch_size=4, device="cpu")(
        z, np.random.RandomState(1).randint(0, cfg.n_classes, 4))
    save_image_grid(imgs, str(tmp_path / "direct.png"))
    png = np.asarray(Image.open(grid))
    assert png.shape == (128, 8 * 128, 3) and png[:, :4 * 128].std() > 0
    np.testing.assert_array_equal(png, np.asarray(Image.open(tmp_path / "direct.png")))


# --- the TF1 Inception ------------------------------------------------------------

def _every_op_graph(seed=0):
    """A graph fed at ``ExpandDims`` that runs every op the executor
    handles: an align-corners resize, a strided SAME conv, batch norm
    without the gamma, SAME max and average pools, both concats, a squeeze,
    an ExpandDims node, a cast, a reshape with a leading 1, a transposed
    MatMul, BiasAdd and Softmax."""
    rng = np.random.RandomState(seed)

    def const(name, a):
        return encode_node(name, "Const", [], {"value": {"tensor": np.asarray(a)}})

    def pool(name, op, inp, k, s, pad):
        return encode_node(name, op, [inp], {"ksize": {"list_i": [1, k, k, 1]},
                                             "strides": {"list_i": [1, s, s, 1]},
                                             "padding": {"s": pad}})

    f32 = np.float32
    nodes = [
        encode_node("ExpandDims", "Placeholder", [], {"dtype": {"type": 1}}),
        const("size", np.asarray([13, 13], np.int32)),
        encode_node("resize", "ResizeBilinear", ["ExpandDims", "size"],
                    {"align_corners": {"b": True}}),
        const("shift", f32(127.5)), const("scale", f32(1 / 127.5)), const("one", f32(1.0)),
        encode_node("sub", "Sub", ["resize", "shift"], {}),
        encode_node("mul", "Mul", ["sub", "scale"], {}),
        encode_node("add", "Add", ["mul", "one"], {}),
        encode_node("id", "Identity", ["add", "^one"], {}),
        const("w", rng.randn(3, 3, 3, 8).astype(f32) * 0.3),
        encode_node("conv", "Conv2D", ["id", "w"], {"strides": {"list_i": [1, 2, 2, 1]},
                                                    "padding": {"s": b"SAME"}}),
        const("m", rng.randn(8).astype(f32) * 0.1), const("v", rng.rand(8).astype(f32) + 0.5),
        const("b", rng.randn(8).astype(f32) * 0.1), const("g", rng.rand(8).astype(f32) + 0.5),
        encode_node("bn", "BatchNormWithGlobalNormalization", ["conv", "m", "v", "b", "g"],
                    {"variance_epsilon": {"f": 1e-3},
                     "scale_after_normalization": {"b": False}}),
        encode_node("relu", "Relu", ["bn"], {}),
        pool("maxpool", "MaxPool", "relu", 3, 2, b"SAME"),
        pool("avgpool", "AvgPool", "relu", 3, 2, b"SAME"),
        const("axis0", np.int32(3)), const("axis1", np.int32(3)),
        encode_node("cat", "Concat", ["axis0", "maxpool", "avgpool"], {}),
        encode_node("cat2", "ConcatV2", ["avgpool", "maxpool", "axis1"], {}),
        pool("pool_3", "AvgPool", "cat", 4, 1, b"VALID"),
        const("flat", np.asarray([1, 16], np.int32)),
        encode_node("sq", "Squeeze", ["pool_3"], {"squeeze_dims": {"list_i": [1, 2]}}),
        const("ax", np.int32(1)),
        encode_node("ex", "ExpandDims", ["sq", "ax"], {}),
        encode_node("reshaped", "Reshape", ["ex", "flat"], {}),
        encode_node("cast", "Cast", ["reshaped"], {"DstT": {"type": 1}}),
        const("W", rng.randn(10, 16).astype(f32) * 0.3),
        encode_node("logits", "MatMul", ["cast", "W"], {"transpose_b": {"b": True}}),
        const("bias", rng.randn(10).astype(f32)),
        encode_node("biased", "BiasAdd", ["logits", "bias"], {}),
        encode_node("softmax", "Softmax", ["biased"], {}),
    ]
    return encode_graphdef(nodes)


@pytest.mark.parametrize("graph", ["mini", "every_op"])
def test_executor_matches_jax(graph):
    """The port's executor on the CPU against JAX's on the same GraphDef and
    images in [0, 255], every fetch at 1e-4."""
    pb = _mini_graph()[0] if graph == "mini" else _every_op_graph()
    fetches = ["pool_3"] if graph == "mini" else ["pool_3", "cat2", "softmax"]
    nodes = parse_graphdef(pb)
    x = np.random.RandomState(1).rand(3, 8, 8, 3).astype(np.float32) * 255
    jexe = jtf.TFGraphExecutor(nodes, feed="ExpandDims", fetches=fetches)
    want = [np.asarray(a) for a in jax.jit(jexe)(jnp.asarray(x))]
    assert set(n.op for n in nodes) <= ttf.TFGraphExecutor.SUPPORTED
    if graph == "every_op":
        assert set(n.op for n in nodes) == ttf.TFGraphExecutor.SUPPORTED
    got = ttf.TFGraphExecutor(nodes, feed="ExpandDims", fetches=fetches, device="cpu")(
        torch.from_numpy(x))
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        np.testing.assert_allclose(g_.numpy(), w, atol=ATOL, rtol=1e-5)


@pytest.fixture(scope="module")
def pb_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tf1") / "classify_image_graph_def.pb"
    path.write_bytes(_mini_graph(2)[0])
    return str(path)


def test_official_evaluator_and_scores_match_jax(pb_path):
    """``OfficialTF1Evaluator`` and ``evaluate_images`` (the [-1, 1] → uint8
    hop, batches of 8, two splits) against JAX's: pools, moments and IS at
    1e-4; ``official_inception_score`` alike."""
    imgs = np.random.RandomState(3).rand(20, 8, 8, 3).astype(np.float32) * 2 - 1
    want = jtf.evaluate_images(jtf.OfficialTF1Evaluator(pb_path), imgs, batch=8, splits=2)
    got = ttf.evaluate_images(ttf.OfficialTF1Evaluator(pb_path, device="cpu"), imgs, batch=8,
                              splits=2)
    for k in ("pool", "mu", "sigma", "IS_mean", "IS_std"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=1e-5)
    preds = np.random.RandomState(4).dirichlet(np.ones(10), size=40).astype(np.float32)
    assert ttf.official_inception_score(preds, 4) == jtf.official_inception_score(preds, 4)


def _same_npz(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=1e-5)


def test_official_eval_cli_paths_match_jax(pb_path, tmp_path):
    """Every path of the CLI against JAX's on the same files: samples as an
    npz (NCHW uint8) and as a pickle (NCHW in [-1, 1]); the ground-truth
    HDF5 with ImageNet-LT's many/low/few strata; FID of two moment files."""
    rng = np.random.RandomState(8)
    x = (rng.rand(12, 3, 8, 8) * 255).astype(np.uint8)
    np.savez(tmp_path / "samples.npz", x=x)
    with open(tmp_path / "samples.pickle", "wb") as f:
        pickle.dump({"x": np.clip(x + 40.0, 0, 255) / 127.5 - 1}, f)
    imgs = rng.randint(0, 255, (30, 3, 8, 8), dtype=np.uint8)
    with h5py.File(tmp_path / "ILSVRC8_val_xy.hdf5", "w") as f:
        f.create_dataset("imgs", data=imgs)
        f.create_dataset("labels", data=rng.randint(0, 3, 30))
    np.save(tmp_path / "spc.npy", np.asarray([150, 50, 10]))
    runs = {
        "npz": [f"samples={tmp_path / 'samples.npz'}", "pool_npz=a.npz"],
        "pickle": [f"samples={tmp_path / 'samples.pickle'}", "pool_npz=b.npz"],
        "ground_truth": ["use_ground_truth_data=1", f"data_root={tmp_path}",
                         "which_dataset=imagenet_lt", "resolution=8", "split=val",
                         f"samples_per_class_path={tmp_path / 'spc.npy'}"],
    }
    for name, args in runs.items():
        outs = {}
        for side, main in (("jax", jofficial.main), ("torch", tofficial.main)):
            out_dir = tmp_path / side
            extra = ["--device", "cpu"] if side == "torch" else []
            outs[side] = main(["--set", f"pb_path={pb_path}", f"out_dir={out_dir}",
                               "batch_size=5", *args, *extra])
        for k in ("IS_mean", "IS_std", "mu", "sigma"):
            np.testing.assert_allclose(outs["torch"][k], outs["jax"][k], atol=ATOL, rtol=1e-5)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch")) and len(files) == 6
    for name in files:
        _same_npz(tmp_path / "jax" / name, tmp_path / "torch" / name)
    fid = ["--set", f"fid_a={tmp_path / 'jax' / 'a.npz'}", f"fid_b={tmp_path / 'jax' / 'b.npz'}"]
    want = jofficial.main(fid)["FID"]
    got = tofficial.main(fid + ["--device", "cpu"])["FID"]
    assert want > 0 and abs(got - want) <= 1e-3 * max(1.0, want)


# --- without a card -----------------------------------------------------------------

def test_entry_points_raise_without_a_card(toy_width, pb_path, tmp_path):
    """Each new entry point defaults to CUDA and raises without a card
    unless given the CPU (``tests/test_torch_port_visualize.py`` holds the
    CLIs of the other half)."""
    from ic_gan_tpu_torch.cli import clip_guided as tcg
    from ic_gan_tpu_torch.models import clip as tclip
    from test_clip import TOY, _random_sd

    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _random_sd(TOY).items()},
               tmp_path / "clip.pt")
    dump, _ = _make_dump(128, 8, np.random.RandomState(0))
    np.savez(tmp_path / "s.npz", x=np.zeros((2, 3, 8, 8), np.uint8))
    for call in (
            lambda: tclip.CLIP(TOY),
            lambda: tclip.load_clip_file(str(tmp_path / "clip.pt")),
            lambda: tcg.main(["--set", f"clip_weights={tmp_path / 'clip.pt'}", "prompt=a"]),
            lambda: ttfhub.load_tfhub_generator(dump, 128),
            lambda: tconvert.main(["--set", "dump=x.h5"]),
            lambda: ttf.TFGraphExecutor(parse_graphdef(_mini_graph()[0]), "ExpandDims",
                                        ["pool_3"]),
            lambda: ttf.OfficialTF1Evaluator(pb_path),
            lambda: tofficial.main(["--set", f"samples={tmp_path / 's.npz'}",
                                    f"pb_path={pb_path}", f"out_dir={tmp_path}"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
