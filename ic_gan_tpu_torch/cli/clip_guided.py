"""CLIP-guided IC-GAN sampling, the colab's flow over a whole population at
once: port of ``ic_gan_tpu/cli/clip_guided.py``.

Reference: ``inference/icgan_colab.ipynb`` "Generate images with IC-GAN +
CLIP!": optimize the noise vector so that CLIP's image embedding of the
generated image matches a text prompt, by CMA-ES (gradient-free), SGD or
Adam (gradients through the generator and CLIP), or their interleaved and
terminal combinations, with random-crop augmentations and the truncation
clamp.

One call evaluates the whole population: the generator on (pop, z) and
CLIP on one (pop, clip_res, clip_res, 3) batch per augmentation, each crop
and resize a pair of per-image bilinear sampling matrices
(``crop_resize_bilinear``).  A gradient takes CLIP's backward one
augmentation at a time into the images and then one backward through the
generator, so that its peak memory is one CLIP batch's graph, not all 64.
CMA-ES (``utils/cma_es.py``) runs on the host in numpy.

    python -m ic_gan_tpu_torch.cli.clip_guided --set prompt="A dragon" \\
        pth_dir=weights/ clip_weights=ViT-B-32.pt bpe_path=bpe.txt.gz \\
        out=best.png [--device cuda]

The crops are drawn from a ``torch.Generator`` seeded ``seed``: the same
searches as the JAX package's given its draws, not its numbers.  Without
crops (one augmentation, or images no larger than ``clip_res``) the search
is deterministic given ``seed`` and follows the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def truncnorm_init(rng: np.random.RandomState, shape, truncation: float) -> np.ndarray:
    """Rejection-sampled N(0, 1) truncated to ±2·truncation (the colab's
    ``truncnorm.rvs(-2t, 2t)``)."""
    out = rng.randn(*shape)
    bad = np.abs(out) > 2 * truncation
    while bad.any():
        out[bad] = rng.randn(int(bad.sum()))
        bad = np.abs(out) > 2 * truncation
    return out.astype(np.float32)


def _crop_matrix(start: torch.Tensor, size: torch.Tensor, out_size: int, in_size: int
                 ) -> torch.Tensor:
    """(B, out_size, in_size) rows of bilinear taps of the window
    [start, start + size) on the half-pixel grid, clamped to the window and
    the image; rows sum to 1."""
    idx_out = torch.arange(out_size, dtype=torch.float32, device=start.device)
    idx_in = torch.arange(in_size, dtype=torch.float32, device=start.device)
    src = start[:, None] + (idx_out + 0.5) * (size / out_size)[:, None] - 0.5
    src = torch.minimum(torch.maximum(src, start[:, None]), (start + size - 1)[:, None])
    src = src.clamp(0.0, in_size - 1.0)
    w = (1.0 - (src[:, :, None] - idx_in).abs()).clamp_min(0.0)
    return w / w.sum(dim=2, keepdim=True)


def crop_resize_bilinear(imgs: torch.Tensor, out_size: int, starts: torch.Tensor,
                         sizes: torch.Tensor) -> torch.Tensor:
    """Per-image crop and bilinear resize to a fixed output size.

    imgs (B, S, S, C); starts (B, 2) float top-left; sizes (B,) float window
    side.  Equal to slicing ``[y:y+s, x:x+s]`` and then ``F.interpolate(
    out_size, bilinear)`` (half-pixel grid), as two (out, S) interpolation
    matrices per image."""
    s = imgs.shape[1]
    starts = torch.as_tensor(starts, dtype=torch.float32, device=imgs.device)
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=imgs.device)
    mh = _crop_matrix(starts[:, 0], sizes, out_size, s).to(imgs.dtype)
    mw = _crop_matrix(starts[:, 1], sizes, out_size, s).to(imgs.dtype)
    x = torch.einsum("boh,bhwc->bowc", mh, imgs)
    return torch.einsum("bpw,bowc->bopc", mw, x)


def normality_loss(vec: torch.Tensor) -> torch.Tensor:
    """KL(N(μ,σ)‖N(0,1)) surrogate (the colab's ``normality_loss``,
    arXiv:1903.00925): μ² + σ² − log σ² − 1."""
    sigma2 = vec.var(unbiased=False)
    return vec.mean().square() + sigma2 - sigma2.log() - 1.0


def clip_guided_search(
    generate: Callable[[torch.Tensor], torch.Tensor],
    encode_image: Callable[[torch.Tensor], torch.Tensor],
    text_features,
    z_dim: int,
    *,
    optimizer: str = "CMA-ES",
    pop_size: int = 50,
    iterations: int = 100,
    terminal_iterations: int = 100,
    truncation: float = 0.7,
    augmentations: int = 64,
    clip_res: int = 224,
    learning_rate: float = 0.1,
    noise_normality_weight: float = 0.0,
    loss_factor: float = 100.0,
    sigma0: float = 0.5,
    seed: Optional[int] = None,
    callback: Optional[Callable] = None,
) -> Dict:
    """Optimize z so that CLIP(generate(z)) matches ``text_features``, on
    the device of ``text_features``.

    ``generate``: (P, z_dim) → (P, S, S, 3) in [-1, 1], differentiable in z
    (the clamp is applied here).  ``encode_image``: (N, clip_res, clip_res,
    3) in [0, 1] → L2-normalized (N, D).  ``optimizer`` is one of the
    colab's menu: 'SGD', 'Adam', 'CMA-ES', 'CMA-ES + {SGD,Adam}
    interleaved', 'CMA-ES + terminal {SGD,Adam}'.  Returns a dict with
    best_z / best_loss / best_iteration / best_image / history."""
    text = torch.as_tensor(text_features)
    text = text[None] if text.dim() == 1 else text
    device = text.device
    state = np.random.RandomState(seed)
    use_cma = "CMA" in optimizer
    grad_name = "SGD" if "SGD" in optimizer else "Adam" if "Adam" in optimizer else None
    interleaved = grad_name is not None and "terminal" not in optimizer
    crop_gen = torch.Generator(device=device).manual_seed(0 if seed is None else seed)
    lo, hi = -2 * truncation, 2 * truncation

    def draw_crops(p: int, s: int):
        """Each augmentation's (starts (P, 2), sizes (P,)): one set per
        iteration, shared by its gradient and its loss evaluation."""
        n_aug = 1 if s <= clip_res else augmentations
        if n_aug == 1:
            return [(torch.zeros((p, 2), device=device), torch.full((p,), float(s),
                                                                     device=device))]
        crops = []
        for _ in range(n_aug):
            sizes = 0.7 * s + 0.28 * s * torch.rand((p,), generator=crop_gen, device=device)
            offs = torch.rand((p, 2), generator=crop_gen, device=device) * (s - sizes[:, None])
            crops.append((offs, sizes))
        return crops

    def cos_of(imgs, crop):        # (P,) prompt-mean cosine of one augmentation
        emb = encode_image((crop_resize_bilinear(imgs, clip_res, *crop) + 1.0) / 2.0)
        return (emb @ text.T).sum(dim=1) / text.shape[0]

    def losses(z, crops_for):
        with torch.no_grad():
            zc = z.clamp(lo, hi)
            imgs = generate(zc)
            crops = crops_for(imgs)
            cos = sum(cos_of(imgs, c) for c in crops) / len(crops)
            loss = loss_factor * (1.0 - cos)
            if noise_normality_weight:
                loss = loss + loss_factor * noise_normality_weight * normality_loss(zc)
        return loss

    def grad(z, crops_for):
        """d sum(losses) / dz: CLIP's backward per augmentation into the
        images, then one backward through the generator."""
        z = z.detach().requires_grad_(True)
        zc = z.clamp(lo, hi)
        imgs = generate(zc)
        crops = crops_for(imgs)
        leaf = imgs.detach().requires_grad_(True)
        for c in crops:
            (-loss_factor / len(crops) * cos_of(leaf, c).sum()).backward()
        terms = [imgs]
        grads = [leaf.grad]
        if noise_normality_weight:
            terms.append(z.shape[0] * loss_factor * noise_normality_weight * normality_loss(zc))
            grads.append(None)
        torch.autograd.backward(terms, grads)
        return z.grad

    def make_opt(param):
        if grad_name == "SGD":
            return torch.optim.SGD([param], lr=learning_rate, momentum=0.9)
        return torch.optim.Adam([param], lr=learning_rate)

    cmaes = None
    if use_cma:
        from ic_gan_tpu_torch.utils.cma_es import CMAES

        cmaes = CMAES(np.zeros(z_dim), sigma0, popsize=pop_size,
                      seed=None if seed is None else seed + 1)

    z_pop = torch.from_numpy(truncnorm_init(state, (pop_size, z_dim), truncation)).to(device)
    param = opt = None
    best = {"loss": np.inf, "z": None, "iteration": 0}
    history = []
    total = iterations + (terminal_iterations if "terminal" in optimizer else 0)
    for i in range(total):
        terminal_phase = use_cma and i >= iterations
        if use_cma and not terminal_phase:
            z_pop = torch.from_numpy(cmaes.ask().astype(np.float32)).to(device)
        if terminal_phase and i == iterations:
            # pop 1 from the global best (the colab's terminal hop), a fresh optimizer
            z_pop = torch.from_numpy(best["z"][None]).to(device)
            param = opt = None
        drawn = []

        def crops_for(imgs):
            if not drawn:
                drawn.append(draw_crops(imgs.shape[0], imgs.shape[1]))
            return drawn[0]

        if grad_name is not None and (interleaved or terminal_phase or not use_cma):
            if param is None:
                param = z_pop.clone()
                opt = make_opt(param)
            with torch.no_grad():
                param.copy_(z_pop)
            param.grad = grad(param, crops_for)
            opt.step()
            z_pop = param.detach().clone()

        losses_np = losses(z_pop, crops_for).cpu().numpy()
        b = int(np.argmin(losses_np))
        if losses_np[b] < best["loss"]:
            best = {"loss": float(losses_np[b]), "z": z_pop[b].cpu().numpy(), "iteration": i}
        if use_cma and not terminal_phase:
            cmaes.tell(z_pop.cpu().numpy(), list(losses_np))
        history.append({"iteration": i, "best": float(losses_np[b]),
                        "mean": float(losses_np.mean())})
        if callback is not None:
            callback(i, losses_np, z_pop)

    with torch.no_grad():
        z_best = torch.from_numpy(best["z"][None]).to(device).clamp(lo, hi)
        best_image = generate(z_best)[0].float().cpu().numpy()
    return {"best_z": best["z"], "best_loss": best["loss"],
            "best_iteration": best["iteration"], "best_image": best_image,
            "history": history}


def main(argv=None):
    """The colab's CLIP-guided search from the command line: a prompt,
    CLIP weights (``clip_weights`` or ``$ICGAN_CLIP_WEIGHTS``), the BPE
    vocabulary (``bpe_path`` or ``$ICGAN_CLIP_BPE``) and a generator as
    ``cli/inference.py:load_generator`` loads one, σ folded, in the
    config's compute type; ``instance_features_npy`` with
    ``input_feature_index`` conditions it on a stored instance,
    ``class_index`` on a class.  Writes the best image to ``out``."""
    from ic_gan_tpu_torch import resolve_device
    from ic_gan_tpu_torch.cli.config import parse_args
    from ic_gan_tpu_torch.cli.inference import device_flag, latent_dim, load_generator
    from ic_gan_tpu_torch.data.tokenizer import SimpleTokenizer, tokenize
    from ic_gan_tpu_torch.io.deploy import fold_spectral_norm
    from ic_gan_tpu_torch.models.clip import load_clip_file

    cfg = parse_args(argv)
    device = resolve_device(device_flag(argv))
    clip_net, clip_cfg = load_clip_file(cfg.get("clip_weights"), device=device)
    clip_net.requires_grad_(False)
    tok = SimpleTokenizer.from_file(cfg.get("bpe_path"))
    tokens = tokenize(cfg["prompt"], tok, clip_cfg.context_length)
    with torch.no_grad():
        text_features = clip_net.encode_text(torch.from_numpy(tokens).to(device))

    g, model_cfg = load_generator(cfg, device)
    # z-search never differentiates the weights: fold σ into them.
    fold_spectral_norm(g).requires_grad_(False)
    feats = None
    if cfg.get("instance_features_npy"):
        bank = np.load(cfg["instance_features_npy"], allow_pickle=True).item()
        idx = cfg.get("input_feature_index", 0)
        feats = torch.as_tensor(bank["instance_features"][idx:idx + 1], device=device)
    class_index = cfg.get("class_index")

    def generate(z):
        c = None if class_index is None else torch.full((z.shape[0],), class_index,
                                                        dtype=torch.long, device=device)
        h = None if feats is None else feats.expand(z.shape[0], -1)
        return g(z, c, h).permute(0, 2, 3, 1)

    out = clip_guided_search(
        generate, clip_net.encode_image, text_features,
        z_dim=latent_dim(model_cfg),
        optimizer=cfg.get("optimizer", "CMA-ES"),
        pop_size=cfg.get("pop_size", 50),
        iterations=cfg.get("iterations", 100),
        terminal_iterations=cfg.get("terminal_iterations", 100),
        truncation=cfg.get("truncation", 0.7),
        augmentations=cfg.get("augmentations", 64),
        clip_res=clip_cfg.image_resolution,
        learning_rate=cfg.get("learning_rate", 0.1),
        noise_normality_weight=cfg.get("noise_normality_loss", 0.0),
        seed=cfg.get("seed"),
    )
    print({"best_loss": round(out["best_loss"], 3), "best_iteration": out["best_iteration"]})
    if cfg.get("out"):
        from PIL import Image

        img = np.uint8(np.clip((out["best_image"] + 1) * 127.5, 0, 255))
        Image.fromarray(img).save(cfg["out"])
    return out


if __name__ == "__main__":
    main()
