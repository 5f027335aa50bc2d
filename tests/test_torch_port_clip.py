"""The port's CLIP guidance stack (``models/clip.py``, ``data/tokenizer.py``,
``utils/cma_es.py``, ``cli/clip_guided.py``) against the JAX package's, on
the CPU.

- CLIP: one random OpenAI-layout state dict at the JAX tests' toy geometry
  (``tests/test_clip.py:TOY``) loaded by both packages; ``encode_image``,
  ``encode_text`` and the logits at 1e-4; ``config_from_state_dict``; the
  converter of JAX's params (``io/convert.py:clip_state_dict_from_jax``).
- The numpy copies (tokenizer, CMA-ES) equal JAX's token for token and
  sample for sample.
- The search's helpers against JAX's; then whole toy searches (a linear
  generator of 16² images, the toy CLIP at 16², so no crops are drawn):
  CMA-ES, Adam and CMA-ES with a terminal Adam, the history and ``best_z``
  at 1e-4.  Deterministic on both sides given ``seed``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ic_gan_tpu.cli import clip_guided as jcg
from ic_gan_tpu.data import tokenizer as jtok
from ic_gan_tpu.models import clip as jclip
from ic_gan_tpu.utils.cma_es import CMAES as JCMAES
from ic_gan_tpu_torch.cli import clip_guided as tcg
from ic_gan_tpu_torch.data import tokenizer as ttok
from ic_gan_tpu_torch.io.convert import clip_state_dict_from_jax
from ic_gan_tpu_torch.models import clip as tclip
from ic_gan_tpu_torch.utils.cma_es import CMAES as TCMAES
from test_clip import TOY, _random_sd
from test_torch_port_classcond import _one_torch_thread, cheap_jit, in_background  # noqa: F401

ATOL = 1e-4


@pytest.fixture(scope="module")
def toy_clip():
    """One random OpenAI state dict in both packages, and the JAX forwards
    compiled in the background."""
    sd = _random_sd(TOY, 1)
    jvars, jcfg = jclip.load_openai_clip(sd, TOY)
    jnet = jclip.CLIP(jcfg)
    net, cfg = tclip.load_openai_clip(sd, TOY, device="cpu")
    rng = np.random.RandomState(2)
    imgs = rng.rand(3, 16, 16, 3).astype(np.float32)
    tokens = rng.randint(0, 40, size=(3, 10)).astype(np.int32)
    tokens[:, 6] = 49                      # EOT: the largest id
    tokens[:, 7:] = 0

    def jax_side():
        fwd = cheap_jit(lambda v, i, t: (jnet.apply(v, i, method=jnet.encode_image),
                                         jnet.apply(v, t, method=jnet.encode_text),
                                         jnet.apply(v, i, t)))
        return [np.asarray(a) for a in jax.tree.leaves(fwd(jvars, jnp.asarray(imgs),
                                                           jnp.asarray(tokens)))]

    return dict(sd=sd, jvars=jvars, jnet=jnet, net=net, cfg=cfg, imgs=imgs, tokens=tokens,
                jax=in_background(jax_side))


def test_clip_matches_jax(toy_clip):
    """encode_image, encode_text and both logits of the same checkpoint, at
    1e-4; the geometry probed alike; JAX's params carried across equal the
    checkpoint the port loaded."""
    t = toy_clip
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(TOY)
    assert dataclasses.asdict(tclip.config_from_state_dict(t["sd"])) == dataclasses.asdict(
        jclip.config_from_state_dict(t["sd"]))
    with torch.no_grad():
        li, lt = t["net"](torch.from_numpy(t["imgs"]), torch.from_numpy(t["tokens"]))
        got = [t["net"].encode_image(torch.from_numpy(t["imgs"])),
               t["net"].encode_text(torch.from_numpy(t["tokens"])), li, lt]
    want = t["jax"].result()
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        np.testing.assert_allclose(g_.numpy(), w, atol=ATOL, rtol=0)
    carried = clip_state_dict_from_jax(t["jvars"])
    own = t["net"].state_dict()
    assert set(carried) == set(own)
    for k, v in carried.items():
        assert torch.equal(v, own[k]), k


def test_tokenizer_and_cma_es_equal_jax():
    """The numpy copies: BPE, encode/decode and ``tokenize`` token for token
    on synthetic merges; CMA-ES (full, diagonal, bounded, no σ adaptation)
    ask for ask over eight generations of a quadratic."""
    merges = [("h", "e"), ("l", "l"), ("l", "o</w>"), ("lo</w>", "w</w>"), ("l", "o"),
              ("lo", "w</w>"), ("d", "r"), ("dr", "a"), ("g", "o"), ("go", "n</w>")]
    jt, tt = jtok.SimpleTokenizer(merges), ttok.SimpleTokenizer(merges)
    for text in ("hello low", "A dragon &amp; a HELLO!", "héllo 42 dragons' go", ""):
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    for ctx in (8, 77):
        np.testing.assert_array_equal(ttok.tokenize(["hello dragon", "go " * 40], tt, ctx),
                                      jtok.tokenize(["hello dragon", "go " * 40], jt, ctx))
    target = np.array([1.5, -2.0, 0.5, 3.0, 0.0])
    for kw in (dict(), dict(diagonal=True), dict(bounds=(-1.0, 1.0)),
               dict(adapt_sigma=False, active=False)):
        es = [cls(np.zeros(5), 0.8, popsize=10, seed=3, **kw) for cls in (JCMAES, TCMAES)]
        for _ in range(8):
            xs = [e.ask() for e in es]
            np.testing.assert_array_equal(xs[0], xs[1])
            for e in es:
                e.tell(xs[0], [float(np.sum((x - target) ** 2)) for x in xs[0]])
        assert es[0].sigma == es[1].sigma and es[0].best_f == es[1].best_f


def test_search_helpers_match_jax():
    """``crop_resize_bilinear`` at fractional windows (and the full one),
    ``normality_loss`` and ``truncnorm_init`` against JAX's."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    starts = np.asarray([[0, 0], [3.25, 7.5], [10.9, 0.4], [1.0, 2.0]], np.float32)
    sizes = np.asarray([32.0, 22.4, 21.1, 30.0], np.float32)
    want = np.asarray(jcg.crop_resize_bilinear(jnp.asarray(x), 24, jnp.asarray(starts),
                                               jnp.asarray(sizes)))
    got = tcg.crop_resize_bilinear(torch.from_numpy(x), 24, torch.from_numpy(starts),
                                   torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    v = rng.randn(50, 12).astype(np.float32) * 0.7 + 0.2
    np.testing.assert_allclose(float(tcg.normality_loss(torch.from_numpy(v))),
                               float(jcg.normality_loss(jnp.asarray(v))), rtol=1e-5)
    np.testing.assert_array_equal(tcg.truncnorm_init(np.random.RandomState(3), (50, 8), 0.7),
                                  jcg.truncnorm_init(np.random.RandomState(3), (50, 8), 0.7))


def _toy_search_problem(toy):
    """A linear generator z (6) → tanh images (P, 16, 16, 3) in both
    packages, the toy CLIP as the scorer, a prompt's text features."""
    w = np.random.RandomState(5).randn(6, 16 * 16 * 3).astype(np.float32) / 2
    text = np.asarray(toy["jnet"].apply(toy["jvars"], jnp.asarray(toy["tokens"][:1]),
                                        method=toy["jnet"].encode_text))

    def jgen(z):
        return jnp.tanh(z @ jnp.asarray(w)).reshape(z.shape[0], 16, 16, 3)

    def tgen(z):
        return torch.tanh(z @ torch.from_numpy(w)).reshape(z.shape[0], 16, 16, 3)

    def jenc(x):
        return toy["jnet"].apply(toy["jvars"], x, method=toy["jnet"].encode_image)

    return jgen, jenc, tgen, toy["net"].encode_image, text


@pytest.mark.parametrize("optimizer", ["CMA-ES", "Adam", "CMA-ES + terminal Adam"])
def test_whole_toy_search_matches_jax(toy_clip, optimizer):
    """A whole search of each kind with images no larger than ``clip_res``
    (no crops drawn) and the normality term on: the per-iteration best and
    mean losses and ``best_z`` at 1e-4, the best iteration equal."""
    jgen, jenc, tgen, tenc, text = _toy_search_problem(toy_clip)
    kw = dict(z_dim=6, optimizer=optimizer, pop_size=8, iterations=4, terminal_iterations=3,
              augmentations=4, clip_res=16, learning_rate=0.05, noise_normality_weight=0.1,
              seed=2)
    want = in_background(jcg.clip_guided_search, jgen, jenc, text, **kw)
    got = tcg.clip_guided_search(tgen, tenc, torch.from_numpy(text), **kw)
    want = want.result()
    assert len(got["history"]) == len(want["history"]) == (7 if "terminal" in optimizer else 4)
    for g_, w in zip(got["history"], want["history"]):
        assert g_["iteration"] == w["iteration"]
        np.testing.assert_allclose([g_["best"], g_["mean"]], [w["best"], w["mean"]],
                                   atol=ATOL, rtol=0)
    assert got["best_iteration"] == want["best_iteration"]
    np.testing.assert_allclose(got["best_z"], want["best_z"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["best_image"], want["best_image"], atol=ATOL, rtol=0)
    assert got["history"][-1]["best"] < got["history"][0]["best"] or optimizer == "CMA-ES"


def test_search_with_crops_draws_one_set_per_iteration():
    """With images larger than ``clip_res`` each iteration draws its crops
    once, and its gradient and its loss see the same crops: a gradient
    search's per-iteration losses equal a fresh evaluation on the crops the
    same generator draws (recorded through ``crop_resize_bilinear``)."""
    seen = []
    orig = tcg.crop_resize_bilinear

    def recording(imgs, out_size, starts, sizes):
        seen.append((starts.clone(), sizes.clone()))
        return orig(imgs, out_size, starts, sizes)

    proj = torch.from_numpy(np.random.RandomState(7).randn(3, 5).astype(np.float32))

    def generate(z):
        return torch.tanh(z[:, :3])[:, None, None, :].expand(z.shape[0], 32, 32, 3) \
            + 0.01 * torch.arange(32.0)[None, :, None, None]

    def encode(x):
        f = x.mean(dim=(1, 2)) @ proj
        return f / f.norm(dim=-1, keepdim=True)

    text = torch.nn.functional.normalize(torch.tensor([[0.9, 0.1, 0.4]]) @ proj, dim=-1)
    tcg.crop_resize_bilinear = recording
    try:
        out = tcg.clip_guided_search(generate, encode, text, z_dim=4, optimizer="Adam",
                                     pop_size=5, iterations=3, augmentations=3, clip_res=16,
                                     seed=1)
    finally:
        tcg.crop_resize_bilinear = orig
    assert len(seen) == 3 * 2 * 3                 # per iteration: 3 crops, gradient and loss
    for it in range(3):
        grad_crops, loss_crops = seen[6 * it: 6 * it + 3], seen[6 * it + 3: 6 * it + 6]
        for (s0, z0), (s1, z1) in zip(grad_crops, loss_crops):
            assert torch.equal(s0, s1) and torch.equal(z0, z1)
            assert (z0 >= 0.7 * 32).all() and (z0 < 0.98 * 32).all()
            assert (s0 >= 0).all() and (s0 + z0[:, None] <= 32).all()
    assert seen[0][1].unique().numel() == 5
    assert np.isfinite(out["best_loss"]) and out["best_image"].shape == (32, 32, 3)
