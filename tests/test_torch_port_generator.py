"""The port's IC-GAN BigGAN generator against the JAX package.

One JAX generator at toy geometry (res 32, G_ch 16, attention at 16², so
Lq 256, Lk 64, d 8, dv 32) with its variables drawn from numpy on the
shapes of its init (no init compile; biases and gains where the init
leaves them, gamma non-zero so attention shows, batch-norm statistics off
their init, one ``accum_counter`` set), converted to the port's
``state_dict`` and run through both packages on the CPU.
"""

import ast
import os

import numpy as np
import pytest
import torch
from torch.nn.utils import skip_init

import jax.numpy as jnp

from ic_gan_tpu.io import deploy as jdeploy
from ic_gan_tpu.io.torch_import import export_generator_state_dict
from ic_gan_tpu.models import biggan as jbiggan
from ic_gan_tpu_torch.io import deploy as tdeploy
from ic_gan_tpu_torch.io.convert import generator_state_dict_from_jax
from ic_gan_tpu_torch.models import biggan as tbiggan
from ic_gan_tpu_torch.models.layers import ConditionalBatchNorm, SelfAttention
from ic_gan_tpu_torch.ops.spectral_norm import spectral_normalize
from test_torch_port_classcond import _one_torch_thread, cheap_jit, numpy_variables  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
JCFG = jbiggan.BigGANConfig(resolution=32, G_ch=16, G_attn="16", dim_z=40,
                            shared_dim_feat=32, instance_sz=64)


def port_cfg(dtype=torch.float32, **kw):
    names = ("resolution", "G_ch", "dim_z", "bottom_width", "G_attn", "hier",
             "class_cond", "instance_cond", "G_shared_feat", "shared_dim_feat",
             "instance_sz", "num_G_SVs", "num_SV_itrs", "SN_eps", "BN_eps",
             "norm_style")
    return tbiggan.BigGANConfig(dtype=dtype, **{**{n: getattr(JCFG, n) for n in names}, **kw})


def _perturb(variables, rng, leaves):
    """Each leaf whose name is in ``leaves`` drawn afresh from ``rng``: BN
    statistics off their init (``mean``, ``var``), gamma non-zero, biases
    and the output gain off zero and one."""
    draw = {
        "mean": lambda a: 0.1 * rng.randn(*a.shape),
        "var": lambda a: rng.uniform(0.5, 1.5, a.shape),
        "gamma": lambda a: np.full(a.shape, 0.5),
        "bias": lambda a: 0.1 * rng.randn(*a.shape),
        "gain": lambda a: 1.0 + 0.1 * rng.randn(*a.shape),
    }

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k in leaves:
                out[k] = jnp.asarray(draw[k](np.asarray(v)).astype(np.float32))
            else:
                out[k] = v
        return out

    return walk(variables, ())


def _at_init(variables, leaves):
    """Each ``bias`` leaf zero and each ``gain`` leaf one, as the init."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (jnp.full_like(v, 1.0 if k == "gain" else 0.0) if k in leaves else v)
                for k, v in node.items()}
    return walk(variables)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    z = rng.randn(BATCH, JCFG.effective_dim_z).astype(np.float32)
    feats = rng.randn(BATCH, JCFG.instance_sz).astype(np.float32)
    g = jbiggan.Generator(JCFG)
    # Variables on the init's shapes, drawn with numpy (no init compile), with
    # the biases and gains where the init leaves them.
    variables = numpy_variables(g, rng, jnp.asarray(z), None, jnp.asarray(feats))
    variables = _perturb(variables, rng, ("mean", "var", "gamma"))
    variables = _at_init(variables, ("bias", "gain"))
    bn = variables["batch_stats"]["block_0"]["bn1"]["bn"]
    # Standing statistics: sums over two accumulations.
    bn.update(accum_counter=jnp.asarray([2.0]), mean=bn["mean"] * 2.0,
              var=bn["var"] * 2.0)
    apply = cheap_jit(lambda v, z, f: g.apply(v, z, None, f, train=False))
    folded = jdeploy.fold_spectral_norm(variables)
    return dict(
        g=g, z=z, feats=feats, variables=variables, folded=folded, apply=apply,
        out=np.asarray(apply(variables, z, feats)),
        out_folded=np.asarray(apply(folded, z, feats)),
    )


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _port(variables, dtype=torch.float32, folded=False):
    g = skip_init(tbiggan.Generator, port_cfg(dtype), device="cpu")
    if folded:
        tdeploy.fold_spectral_norm(g)
    g.load_state_dict(generator_state_dict_from_jax(variables, port_cfg()))
    return g.eval()


def _run(g, m, z=None, feats=None, **kw):
    z = m["z"] if z is None else z
    feats = m["feats"] if feats is None else feats
    with torch.no_grad():
        return g(torch.from_numpy(z), None, torch.from_numpy(feats), **kw)


def _attn(g) -> SelfAttention:
    (attn,) = [m for m in g.modules() if isinstance(m, SelfAttention)]
    return attn


# --- (f) converter -------------------------------------------------------------

@pytest.mark.parametrize("tree", ["variables", "folded"])
def test_converter_matches_export(jax_model, tree):
    got = generator_state_dict_from_jax(jax_model[tree], port_cfg())
    # The export's key map always names u0/sv0; a folded tree has none.
    ref = export_generator_state_dict(
        {**jax_model[tree], "sn": jax_model["variables"]["sn"]}, JCFG)
    if tree == "folded":
        ref = {k: v for k, v in ref.items() if not k.endswith((".u0", ".sv0"))}
    counters = {k for k in got if k.endswith(".accum_counter")}
    assert set(got) == set(ref) | counters
    assert len(counters) == 2 * len(JCFG.g_arch["in_channels"]) + 1
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(got["blocks.0.0.bn1.accum_counter"].numpy(), [2.0])


def test_state_dict_keys_are_the_reference_names(jax_model):
    g = tbiggan.Generator(port_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
    assert set(g.state_dict()) == set(
        generator_state_dict_from_jax(jax_model["variables"], port_cfg()))


# --- (g) whole G, unfolded f32 ------------------------------------------------

@pytest.mark.parametrize("biases", ["init", "perturbed"])
def test_generator_unfolded_f32_matches_jax(jax_model, biases):
    variables, ref = jax_model["variables"], jax_model["out"]
    if biases == "perturbed":
        variables = _perturb(variables, np.random.RandomState(3), ("bias", "gain"))
        ref = np.asarray(jax_model["apply"](variables, jax_model["z"], jax_model["feats"]))
    g = _port(variables)
    assert _attn(g)._fused_qkv_weight() is None
    out = _run(g, jax_model)
    assert out.shape == (BATCH, 3, 32, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(_nchw_to_nhwc(out), ref, atol=1e-4)


# --- (h) whole G, folded f32 -------------------------------------------------

@pytest.mark.parametrize("fold_by", ["port", "jax"])
def test_generator_folded_f32_matches_jax(jax_model, fold_by):
    if fold_by == "port":
        g = tdeploy.fold_spectral_norm(_port(jax_model["variables"]))
    else:
        g = _port(jax_model["folded"], folded=True)
    assert not any(k.endswith((".u0", ".sv0")) for k in g.state_dict())
    # The fused θ/φ/g projection runs only on folded weights.
    assert _attn(g)._fused_qkv_weight() is not None
    np.testing.assert_allclose(_nchw_to_nhwc(_run(g, jax_model)),
                               jax_model["out_folded"], atol=1e-4)


# --- (i) whole G, bf16 -----------------------------------------------------------

def test_generator_bf16_matches_jax_f32(jax_model):
    g = tdeploy.cast_params(_port(jax_model["folded"], torch.bfloat16, folded=True))
    assert all(p.dtype == torch.bfloat16 for p in g.parameters())
    assert all(b.dtype == torch.float32 for b in g.buffers())
    out = _run(g, jax_model)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nchw_to_nhwc(out), jax_model["out_folded"], atol=0.05)


def test_fold_after_cast_finds_sigma_in_f32(jax_model):
    """make_sampler folds a model whose weights cast_params already made bf16:
    σ comes from those bf16 weights, in float32, against the float32 u."""
    g = tdeploy.cast_params(_port(jax_model["variables"], torch.bfloat16))
    conv = g.blocks[0][0].conv1
    w = conv.weight.detach().float()
    sigma = spectral_normalize(w, conv.u0)[2][0]
    sampler = tdeploy.make_sampler(g, batch_size=BATCH, device="cpu")
    assert conv.folded and conv.weight.dtype == torch.bfloat16
    torch.testing.assert_close(conv.weight.detach(), (w / sigma).to(torch.bfloat16),
                               rtol=0, atol=0)
    out = sampler(jax_model["z"], feats=jax_model["feats"])
    assert out.shape == (BATCH, 32, 32, 3) and np.isfinite(out).all()


# --- (j) make_sampler --------------------------------------------------------

def test_make_sampler_pads_the_tail(jax_model):
    rng = np.random.RandomState(7)
    n = 7  # not a multiple of the batch: the tail batch is padded
    z = rng.randn(n, JCFG.effective_dim_z).astype(np.float32)
    feats = rng.randn(n, JCFG.instance_sz).astype(np.float32)
    g = _port(jax_model["variables"])
    sampler = tdeploy.make_sampler(g, batch_size=BATCH, device="cpu")
    out = sampler(z, feats=feats)
    assert isinstance(out, np.ndarray) and out.shape == (n, 32, 32, 3)
    assert out.dtype == np.float32
    ref = _nchw_to_nhwc(_run(g, jax_model, z=z, feats=feats))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    dev = sampler(torch.from_numpy(z), feats=torch.from_numpy(feats),
                  device_output=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)


def test_make_sampler_defaults_to_cuda(jax_model):
    if torch.cuda.is_available():
        pytest.skip("this checks the error raised without CUDA")
    g = _port(jax_model["folded"], folded=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdeploy.make_sampler(g, batch_size=BATCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbiggan.Generator(port_cfg())


# --- (k) standing statistics ---------------------------------------------------

def test_standing_forward_matches_jax(jax_model):
    folded = jax_model["folded"]
    z, feats = jax_model["z"], jax_model["feats"]
    _, mut = cheap_jit(lambda v, z, f: jax_model["g"].apply(
        v, z, None, f, train=False, standing=True, mutable=["batch_stats"]))(folded, z, feats)
    ref = generator_state_dict_from_jax({**folded, **mut}, port_cfg())
    g = _port(folded, folded=True)
    _run(g, jax_model, standing=True)
    got = g.state_dict()
    keys = [k for k in ref if k.endswith(("stored_mean", "stored_var", "accum_counter"))]
    assert len(keys) == 3 * (2 * len(JCFG.g_arch["in_channels"]) + 1)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_accumulate_standing_stats_averages(jax_model):
    g = _port(jax_model["folded"], folded=True)
    rng = np.random.RandomState(9)
    tdeploy.accumulate_standing_stats(
        g, torch.Generator().manual_seed(0),
        lambda n: (None, rng.randn(n, JCFG.instance_sz).astype(np.float32)),
        batch_size=3, n_accumulations=2)
    for m in g.modules():
        if isinstance(m, ConditionalBatchNorm):
            assert float(m.accum_counter[0]) == 2.0
            assert torch.all(m.stored_var > 0)
    out = _run(g, jax_model)
    assert torch.isfinite(out).all()
    tdeploy.reset_standing_stats(g)
    assert all(float(m.accum_counter[0]) == 0.0 for m in g.modules()
               if isinstance(m, ConditionalBatchNorm))


# --- (l) norm styles: each builds and runs; a misspelt one raises ----------------

@pytest.mark.parametrize("style", ["in", "gn", "nonorm"])
def test_unported_norm_style_raises(style):
    """Every style is ported now (the parity tests are in
    ``test_torch_port_classcond.py``): the style's G builds and gives finite
    images of the right shape, and a style no branch knows raises."""
    g = tbiggan.Generator(port_cfg(norm_style=style), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        out = g(torch.from_numpy(rng.randn(2, JCFG.effective_dim_z).astype(np.float32)), None,
                torch.from_numpy(rng.randn(2, JCFG.instance_sz).astype(np.float32)))
    assert out.shape == (2, 3, 32, 32) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown norm_style"):
        tbiggan.Generator(port_cfg(norm_style="x" + style), device="cpu")


def test_training_mode_updates_state_and_matches_jax(jax_model):
    """Train mode: batch-moment normalization, and every layer advances its
    SN state and moves its BN running statistics, as JAX's train=True."""
    variables = jax_model["variables"]
    ref, mut = cheap_jit(lambda v, z, f: jax_model["g"].apply(
        v, z, None, f, train=True, mutable=["batch_stats", "sn"]))(
            variables, jax_model["z"], jax_model["feats"])
    new = generator_state_dict_from_jax({"params": variables["params"], **mut}, port_cfg())
    g = _port(variables).train()
    before = {k: v.clone() for k, v in g.state_dict().items()}
    out = _run(g, jax_model)
    np.testing.assert_allclose(_nchw_to_nhwc(out), np.asarray(ref), atol=1e-4)
    keys = [k for k in new if k.endswith((".u0", ".sv0", ".stored_mean", ".stored_var"))]
    assert len(keys) > 40
    for k in keys:
        got = g.state_dict()[k]
        assert not torch.equal(got, before[k]) or k.endswith(".sv0"), k
        np.testing.assert_allclose(got.numpy(), new[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# --- (m) the port imports no JAX ---------------------------------------------

FORBIDDEN = {"jax", "flax", "optax", "ic_gan_tpu", "__graft_entry__"}


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ic_gan_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) >= 20 and os.path.exists(files[0])
    # The walk reaches every slice's modules, the StyleGAN2-ADA ones, the
    # StyleGAN2 loop's (utils/, cli/, the dataset, checkpoints, the importer),
    # the BigGAN loop's (DiffAugment, distributions, the .pth loaders, the
    # trainer and its CLI), the eval stack's (Inception, eval/) and the
    # inference slice's (BigGAN-deep, ResNet-50, the sampling CLIs) and the
    # data-preparation and eval-CLI slice's (readers, COCO tools, VGG16) and the
    # int8 serving slice's (io/quant.py, ops/int8_conv.py) and the last CLIs'
    # and pretrained-weight paths' (sheets, projector, log plots, CLIP and its
    # guided search, the tokenizer, CMA-ES, TFHub, the TF1 Inception) and the
    # batch loader and data parallelism (data/loader.py, parallel/) included.
    rel = {os.path.relpath(f, os.path.join(ROOT, "ic_gan_tpu_torch")) for f in files}
    assert {"data/ada.py", "data/fast_warp.py", "ops/row_shift.py", "ops/bias_act.py",
            "ops/conv_resample.py", "models/stylegan2.py", "train/stylegan2_step.py",
            "train/stylegan2_trainer.py", "utils/logging.py", "utils/tensorboard.py",
            "cli/config.py", "cli/train_stylegan2.py", "data/datasets.py",
            "data/feature_bank.py", "io/checkpoint.py", "io/graphdef.py",
            "io/stylegan_import.py", "data/augment.py", "data/distributions.py",
            "io/torch_import.py", "train/trainer.py", "cli/train.py",
            "cli/inference.py", "models/inception.py", "eval/__init__.py", "eval/fid.py",
            "eval/prdc.py", "eval/pipeline.py", "eval/metrics.py", "models/biggan_deep.py",
            "models/resnet.py", "cli/generate_images.py", "cli/sample.py", "cli/demo.py",
            "data/image_datasets.py", "io/lmdb_reader.py", "data/archive_readers.py",
            "cli/prepare_data.py", "cli/store_coco_images.py", "models/vgg.py",
            "io/convert.py", "cli/test.py", "cli/calc_metrics.py", "io/quant.py",
            "ops/int8_conv.py", "cli/visualize.py", "cli/projector.py", "cli/plot_logs.py",
            "utils/cma_es.py", "data/tokenizer.py", "models/clip.py", "cli/clip_guided.py",
            "io/tfhub_import.py", "cli/convert_tfhub.py", "eval/tf_inception.py",
            "cli/official_eval.py", "data/loader.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/collectives.py", "parallel/stats.py"} <= rel
    bad = {(os.path.relpath(f, ROOT), r) for f in files for r in _imported_roots(f)
           if r in FORBIDDEN}
    assert not bad, bad
    # The check tells the port's own name from the JAX package's.
    assert "ic_gan_tpu" not in set(_imported_roots(
        os.path.join(ROOT, "ic_gan_tpu_torch", "models", "layers.py")))
