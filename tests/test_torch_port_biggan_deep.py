"""The port's BigGAN-deep (``models/biggan_deep.py``, its key maps in
``io/convert.py``, ``split_config`` and ``Trainer`` on it) against the JAX
package's, on the CPU.

Toy geometry: res 32, ch 8, depth 2 (1 for the class-only and
instance-only models), attention at 16² in G (d 4, dv 16) and in every D
stage.  The port's G and D are drawn from a seed, their
batch-norm statistics and attention gammas moved off their init, and the
JAX variables are made from their state dicts through the inverse of the
key maps (JAX's ``init`` compiles for 24 s here and is never called).  Each
conditioning (class only, instance only, class and instance) has one
compiled JAX function of the eval-mode G and D, shared through a module
fixture; the class-and-instance model also runs in train mode, in float64,
with its gradients.  XLA compiles at its cheapest settings (``cheap_jit``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.utils import skip_init

import jax
import jax.numpy as jnp

from ic_gan_tpu.io import torch_import as jimport
from ic_gan_tpu.models import biggan_deep as jdeep
from ic_gan_tpu_torch.cli import config as tconfig
from ic_gan_tpu_torch.io import convert
from ic_gan_tpu_torch.models import biggan_deep as tdeep
from ic_gan_tpu_torch.models.layers import SelfAttention
from ic_gan_tpu_torch.train import trainer as ttrainer
from test_torch_port_classcond import _one_torch_thread, cheap_jit  # noqa: F401

BATCH = 4
GEOMETRY = dict(resolution=32, G_ch=8, D_ch=8, G_attn="16", D_attn="16", n_classes=10,
                instance_sz=24, shared_dim=16, shared_dim_feat=16, dim_z=20, hier=True)
# Class only and instance only at depth 1 (half the JAX compile); class and
# instance at depth 2.
MODES = {"class": dict(class_cond=True, instance_cond=False, G_depth=1, D_depth=1),
         "instance": dict(class_cond=False, instance_cond=True, G_depth=1, D_depth=1),
         "class+instance": dict(class_cond=True, instance_cond=True)}
# f32 bars: eval-mode images in [-1, 1] to 1e-5, train-mode ones to 1e-4
# (batch norm over 4 samples scales f32 reassociation noise up; 1.4e-5
# seen); D's scores (|D| up to ~50 here) to 1e-5 of max(1, max|D|); SN and
# BN state to 1e-5 relative.
IMG_ATOL, IMG_TRAIN_ATOL, D_REL, STATE_REL = 1e-5, 1e-4, 1e-5, 1e-5

_INVERSE = {convert._t_linear: lambda t: t.T,
            convert._t_conv: lambda t: np.transpose(t, (2, 3, 1, 0)),
            convert._ident: lambda t: t}


def jax_variables(state_dict, key_map):
    """The JAX variable tree of a port state dict, through the inverse of
    ``key_map`` (every entry must be there)."""
    tree = {}
    for path, (key, transform) in key_map.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _INVERSE[transform](state_dict[key].numpy().astype(np.float32))
    return tree


def _perturb(net, seed):
    """Batch-norm statistics off their init, one standing counter set,
    attention gammas at 0.5 and biases off zero."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("stored_mean") or (name.endswith(".bias") and t.dim() == 1):
                t.copy_(torch.from_numpy(0.1 * rng.randn(*t.shape)))
            elif name.endswith("stored_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
        for m in net.modules():
            if isinstance(m, SelfAttention):
                m.gamma.fill_(0.5)
    return net


def _build(mode, dtype=torch.float32):
    cfg = tdeep.BigGANDeepConfig(**GEOMETRY, **MODES[mode], dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    g = _perturb(tdeep.Generator(cfg, device="cpu", generator=gen), 1)
    d = _perturb(tdeep.Discriminator(cfg, device="cpu", generator=gen), 2)
    return cfg, g, d


def _inputs(cfg, seed=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(BATCH, cfg.dim_z).astype(np.float32)
    label = rng.randint(0, cfg.n_classes, BATCH) if cfg.class_cond else None
    feats = rng.randn(BATCH, cfg.instance_sz).astype(np.float32) if cfg.instance_cond else None
    x = rng.uniform(-1, 1, (BATCH, 3, 32, 32)).astype(np.float32)
    return z, label, feats, x


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module")
def models():
    """Per mode: the port's G and D, their JAX variables, and JAX's G and D
    eval forwards."""
    out = {}
    for mode in MODES:
        cfg, g, d = _build(mode)
        jcfg = jdeep.BigGANDeepConfig(**GEOMETRY, **MODES[mode])
        jg, jd = jdeep.Generator(jcfg), jdeep.Discriminator(jcfg)
        gv = jax_variables(g.state_dict(), convert.deep_generator_key_map(cfg))
        dv = jax_variables(d.state_dict(), convert.deep_discriminator_key_map(cfg))

        @cheap_jit
        def run(gv, dv, z, label, feats, x, jg=jg, jd=jd):
            return (jg.apply(gv, z, label, feats, train=False),
                    jd.apply(dv, x, label, feats, train=False))

        z, label, feats, x = _inputs(cfg)
        ref = run(gv, dv, _j(z), _j(label), _j(feats), _j(np.transpose(x, (0, 2, 3, 1))))
        out[mode] = dict(cfg=cfg, g=g, d=d, gv=gv, dv=dv, ref=jax.device_get(ref),
                         inputs=(z, label, feats, x))
    return out


def _state_err(net, new_tree, key_map):
    """Worst relative |Δ| between the port's SN/BN state after a train
    forward and JAX's; the count of tensors compared."""
    sd = net.state_dict()
    worst, n = 0.0, 0
    for path, (key, transform) in key_map.items():
        if path[0] not in new_tree:
            continue
        node = new_tree
        for p in path:
            node = node[p]
        got = sd[key].numpy()
        want = np.asarray(transform(np.asarray(node)))
        worst = max(worst, np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
        n += 1
    return worst, n


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax(models, mode):
    """Eval-mode G and D against JAX (the train-mode forwards:
    ``test_train_forward_and_gradients_match_jax``)."""
    m = models[mode]
    z, label, feats, x = m["inputs"]
    img, score = m["ref"]
    with torch.no_grad():
        got = m["g"](_t(z), _t(label), _t(feats)).permute(0, 2, 3, 1).numpy()
        got_d = m["d"](_t(x), _t(label), _t(feats)).numpy()
    assert got.shape == (BATCH, 32, 32, 3) and got_d.shape == (BATCH, 1)
    assert np.abs(got - img).max() <= IMG_ATOL and img.std() > 1e-2
    assert np.abs(got_d - score).max() <= D_REL * max(1.0, np.abs(score).max())


def _block_key_map(block):
    """JAX path → (torch key, transform) of one deep block, by the key maps'
    own helpers."""
    m = {}
    for k in range(1, 5):
        if isinstance(block, tdeep.DeepGBlock):
            convert._ccbn(m, (f"bn{k}",), f"bn{k}", "bn")
        convert._conv(m, (f"conv{k}",), f"conv{k}")
    if getattr(block, "conv_sc", None) is not None:
        convert._conv(m, ("conv_sc",), "conv_sc")
    return m


def test_blocks_with_channel_drop_and_concat_match_jax():
    """The shortcuts the res-32 models do not reach: a G block dropping
    channels (16 → 8) as it upsamples, a D block appending ``conv_sc``'s
    channels (8 → 16) as it downsamples; eval and train forwards, and the
    state a train forward leaves, against JAX's blocks."""
    gen = torch.Generator().manual_seed(4)
    gb = _perturb(tdeep.DeepGBlock(16, 8, 6, upsample=True, device="cpu", generator=gen), 5).eval()
    db = _perturb(tdeep.DeepDBlock(8, 16, downsample=True, device="cpu", generator=gen), 6).eval()
    jgb = jdeep.DeepGBlock(16, 8, upsample=True)
    jdb = jdeep.DeepDBlock(8, 16, downsample=True)
    gmap, dmap = _block_key_map(gb), _block_key_map(db)
    gv, dv = jax_variables(gb.state_dict(), gmap), jax_variables(db.state_dict(), dmap)
    rng = np.random.RandomState(7)
    x, y = rng.randn(3, 16, 8, 8).astype(np.float32), rng.randn(3, 6).astype(np.float32)
    xd = rng.randn(3, 8, 8, 8).astype(np.float32)
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))  # noqa: E731

    @cheap_jit
    def run(gv, dv, x, y, xd):
        return (jgb.apply(gv, x, y, train=False),
                jgb.apply(gv, x, y, train=True, mutable=["sn", "batch_stats"]),
                jdb.apply(dv, xd, update_sn=False),
                jdb.apply(dv, xd, update_sn=True, mutable=["sn"]))

    g_eval, (g_train, g_new), d_eval, (d_train, d_new) = jax.device_get(
        run(gv, dv, nhwc(x), jnp.asarray(y), nhwc(xd)))
    with torch.no_grad():
        outs = [gb(_t(x), _t(y)), db(_t(xd))]
        gb.train(), db.train()
        outs += [gb(_t(x), _t(y)), db(_t(xd))]
    assert tuple(outs[0].shape) == (3, 8, 16, 16) and tuple(outs[1].shape) == (3, 16, 4, 4)
    for got, want, bar in ((outs[0], g_eval, IMG_ATOL), (outs[1], d_eval, IMG_ATOL),
                           (outs[2], g_train, IMG_TRAIN_ATOL), (outs[3], d_train, IMG_ATOL)):
        want = np.asarray(want)
        assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= bar * max(
            1.0, np.abs(want).max())
    for net, new, key_map in ((gb, g_new, gmap), (db, d_new, dmap)):
        err, n = _state_err(net, new, key_map)
        assert err <= STATE_REL and n >= 8


def test_deep_key_maps_round_trip(models):
    """JAX variables → the port's state dicts → the JAX package's own
    ``export_*_state_dict(deep=True)``: the same upstream names and values,
    the port's standing counters aside; the folded tree drops u0/sv0."""
    m = models["class+instance"]
    cfg = m["cfg"]
    jcfg = jdeep.BigGANDeepConfig(**GEOMETRY, **MODES["class+instance"], G_shared_feat=True)
    for tree, export, ours in (
            (m["gv"], jimport.export_generator_state_dict, convert.generator_state_dict_from_jax),
            (m["dv"], jimport.export_discriminator_state_dict,
             convert.discriminator_state_dict_from_jax)):
        want = export(tree, jcfg, deep=True)
        got = ours(tree, cfg)
        assert set(got) - set(want) == {k for k in got if k.endswith("accum_counter")}
        assert set(want) <= set(got)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(m["g"].state_dict()) == set(convert.generator_state_dict_from_jax(
        m["gv"], cfg))
    assert any(k.startswith("blocks.3.1.theta") for k in m["g"].state_dict())  # stage 1's attention
    assert set(m["d"].state_dict()) == set(convert.discriminator_state_dict_from_jax(
        m["dv"], cfg))
    folded = {c: v for c, v in m["gv"].items() if c != "sn"}
    assert not any(k.endswith(("u0", "sv0")) for k in convert.generator_state_dict_from_jax(
        folded, cfg))


def test_train_forward_and_gradients_match_jax(models):
    """Train mode with class and instance conditioning, float64 interior on
    both sides (JAX under ``enable_x64``, the port's models built in
    float64): G's images, D's scores and the spectral-norm and batch-norm
    state the forwards leave, and d/dθ of mean(D(G(z))) over G's and D's
    parameters.  Both round G's images and D's scores to float32, where the
    bars start: images 1e-5, scores and the loss 1e-6 relative, state 1e-5
    relative, gradients 1e-5 of each tensor's largest entry plus 1e-7 of the
    network's."""
    m = models["class+instance"]
    z, label, feats, _ = m["inputs"]
    cfg64 = m["cfg"].replace(dtype=torch.float64)
    with jax.enable_x64(True):
        jcfg = jdeep.BigGANDeepConfig(**GEOMETRY, **MODES["class+instance"], dtype=jnp.float64)
        jg, jd = jdeep.Generator(jcfg), jdeep.Discriminator(jcfg)
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        gv, dv = cast(m["gv"]), cast(m["dv"])
        z64, f64 = cast(z), cast(feats)

        def loss(gp, dp):
            img, g_new = jg.apply({**gv, "params": gp}, z64, _j(label), f64, train=True,
                                  mutable=["sn", "batch_stats"])
            out, d_new = jd.apply({**dv, "params": dp}, img, _j(label), f64, train=True,
                                  mutable=["sn"])
            return jnp.mean(out), (img, out, g_new, d_new)

        (val, (img, score, g_new, d_new)), (jgg, jdg) = cheap_jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(gv["params"], dv["params"])
        val, img, score, g_new, d_new, jgg, jdg = jax.device_get(
            (float(val), img, score, g_new, d_new, jgg, jdg))
    g = skip_init(tdeep.Generator, cfg64, device="cpu").double()
    d = skip_init(tdeep.Discriminator, cfg64, device="cpu").double()
    g.load_state_dict(m["g"].state_dict())
    d.load_state_dict(m["d"].state_dict())
    g.train(), d.train()
    got_img = g(_t(z).double(), _t(label), _t(feats).double())
    got_score = d(got_img, _t(label), _t(feats).double())
    out = torch.mean(got_score)
    out.backward()
    assert np.abs(got_img.detach().permute(0, 2, 3, 1).numpy() - img).max() <= IMG_ATOL
    assert np.abs(img - np.asarray(m["ref"][0])).max() > 1e-3       # train mode differs
    assert np.abs(got_score.detach().numpy() - score).max() <= 1e-6 * np.abs(score).max()
    assert abs(out.item() - val) <= 1e-6 * max(1.0, abs(val))
    for net, new, key_map in ((g, g_new, convert.deep_generator_key_map(m["cfg"])),
                              (d, d_new, convert.deep_discriminator_key_map(m["cfg"]))):
        err, n = _state_err(net, new, key_map)
        assert err <= STATE_REL and n > 40
    for net, grads, key_map in ((g, jgg, convert.deep_generator_key_map(m["cfg"])),
                                (d, jdg, convert.deep_discriminator_key_map(m["cfg"]))):
        want = convert.tree_to_torch(grads, key_map)
        got = {k: p.grad for k, p in net.named_parameters()}
        assert set(got) == set(want)
        top = max(v.abs().max().item() for v in want.values())
        assert top > 0
        for k, w in want.items():
            err = (got[k] - w.double()).abs().max().item()
            assert err <= 1e-5 * w.abs().max().item() + 1e-7 * top, (k, err)


class _Dataset:
    """The dataset surface the trainer reads: labelled images and unit
    features drawn from a seed, indices from ``rng``."""

    which_nn_balance = "instance_balance"

    def __init__(self, cfg, n=12, seed=0):
        gen = torch.Generator().manual_seed(seed)
        self.images = torch.rand((n, 3, cfg.resolution, cfg.resolution), generator=gen) * 2 - 1
        self.labels = torch.randint(0, cfg.n_classes, (n,), generator=gen)
        self.feats = F.normalize(torch.randn((n, cfg.instance_sz), generator=gen), dim=1)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.images)

    def sample_batch(self, n, weights=None):
        from ic_gan_tpu_torch.data.datasets import Batch

        i = self.rng.integers(0, len(self), n)
        return Batch(self.images[i], self.labels[i], self.feats[i], None)

    def sample_conditioning_instance_balance(self, n, weights=None):
        i = self.rng.integers(0, len(self), n)
        return self.labels[i], self.feats[i]


def test_split_config_and_trainer_run_deep(tmp_path):
    """``model: BigGANdeep`` through ``split_config`` into ``Trainer``: two
    steps of the toy deep G and D on the CPU, finite losses, the step's
    weights and SN state moved; the snapshot reloads bit for bit into a
    fresh trainer."""
    flat = dict(model="BigGANdeep", **{k: v for k, v in GEOMETRY.items() if k != "instance_sz"},
                class_cond=True, instance_cond=True, G_shared_feat=True, batch_size=2,
                num_D_steps=1, ema=True, ema_start=0, experiment_name="deep",
                weights_root=str(tmp_path / "w"), logs_root=str(tmp_path / "l"),
                no_tb=True, num_epochs=1, log_every=1, seed=5)
    model_cfg, train_cfg, trainer_cfg, _ = tconfig.split_config(flat)
    assert isinstance(model_cfg, tdeep.BigGANDeepConfig) and model_cfg.G_depth == 2
    tr = ttrainer.Trainer(model_cfg, train_cfg, trainer_cfg, _Dataset(model_cfg), device="cpu")
    assert isinstance(tr.state.g, tdeep.Generator) and isinstance(tr.state.d, tdeep.Discriminator)
    before = {k: v.clone() for k, v in tr.state.g.state_dict().items()}
    tr.run(steps_per_epoch=2)
    assert tr.history["itr"] == 2
    after = tr.state.g.state_dict()
    assert not torch.equal(after["blocks.0.0.conv2.weight"], before["blocks.0.0.conv2.weight"])
    assert not torch.equal(after["blocks.0.0.conv2.u0"], before["blocks.0.0.conv2.u0"])
    fresh = ttrainer.Trainer(model_cfg, train_cfg, dataclasses.replace(trainer_cfg, seed=6),
                             _Dataset(model_cfg), device="cpu")
    fresh.resume()
    for name in ("g", "d", "g_ema"):
        live, back = getattr(tr.state, name).state_dict(), getattr(fresh.state, name).state_dict()
        assert all(torch.equal(v, back[k]) for k, v in live.items()), name
    assert fresh.history["itr"] == 2
