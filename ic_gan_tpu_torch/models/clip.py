"""CLIP (ViT image encoder and text transformer) in PyTorch, the scorer of
the CLIP-guided search: port of ``ic_gan_tpu/models/clip.py``.

The reference's CLIP-guided notebook (``inference/icgan_colab.ipynb``, cell
"Generate images with IC-GAN + CLIP!") steers IC-GAN sampling by the cosine
similarity between ``clip.encode_image(generated)`` and
``clip.encode_text(prompt)``.  This module is OpenAI's ViT-B/32 architecture
(quick-GELU transformer blocks, packed-qkv attention, EOT-token text
pooling) under the names of OpenAI's ``state_dict``, so that a checkpoint
loads with a checked ``load_state_dict`` (``load_openai_clip``); the
weights are env-gated (``$ICGAN_CLIP_WEIGHTS``, ``load_clip_file``).

The attention is plain ``scaled_dot_product_attention`` (the JAX package
computes it outside any Pallas kernel too).  Images are NHWC in [0, 1],
as the JAX package takes them.  ``vit_b32()`` is the published geometry;
every width is configurable, so tests run at toy size.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ic_gan_tpu_torch import resolve_device

# CLIP's image normalization (the colab's `nom`, applied after resize).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# Entries of OpenAI's jit checkpoint that are not weights (its
# ``build_model`` drops them too).
_NON_WEIGHT_KEYS = ("input_resolution", "context_length", "vocab_size")


@dataclass(frozen=True)
class CLIPConfig:
    image_resolution: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8


def vit_b32() -> CLIPConfig:
    return CLIPConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _normal(shape, std, device, generator):
    return nn.Parameter(torch.empty(shape, device=device).normal_(0.0, std, generator=generator))


class MultiheadAttention(nn.Module):
    """Packed-qkv attention with ``torch.nn.MultiheadAttention``'s parameter
    names (the layout OpenAI's checkpoints store); batch-first input."""

    def __init__(self, width: int, heads: int, device=None, generator=None):
        super().__init__()
        self.heads = heads
        bound = math.sqrt(6.0 / (4 * width))           # Xavier uniform of (3D, D)
        self.in_proj_weight = nn.Parameter(torch.empty((3 * width, width), device=device)
                                           .uniform_(-bound, bound, generator=generator))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, length, width = x.shape
        q, k, v = (t.reshape(b, length, self.heads, width // self.heads).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, length, width))


class ResidualBlock(nn.Module):
    """OpenAI's ``ResidualAttentionBlock``: pre-norm attention and a
    quick-GELU MLP (``mlp.c_fc``, ``mlp.c_proj``)."""

    def __init__(self, width: int, heads: int, device=None, generator=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.attn = MultiheadAttention(width, heads, device, generator)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.mlp = nn.ModuleDict(dict(c_fc=nn.Linear(width, 4 * width, device=device),
                                      c_proj=nn.Linear(4 * width, width, device=device)))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.mlp["c_proj"](quick_gelu(self.mlp["c_fc"](self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None, generator=None):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads, device, generator)
                                       for _ in range(layers))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, causal=causal)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None, generator=None):
        super().__init__()
        c, width = cfg, cfg.vision_width
        grid = c.image_resolution // c.patch_size
        self.patch_size = c.patch_size
        self.conv1 = nn.Conv2d(3, width, c.patch_size, stride=c.patch_size, bias=False,
                               device=device)
        self.class_embedding = _normal((width,), 0.02, device, generator)
        self.positional_embedding = _normal((grid * grid + 1, width), 0.02, device, generator)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5, device=device)
        self.transformer = Transformer(width, c.vision_layers, c.vision_heads, device, generator)
        self.ln_post = nn.LayerNorm(width, eps=1e-5, device=device)
        self.proj = _normal((width, c.embed_dim), 0.02, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W), CLIP-normalized → (B, embed_dim), not normalized."""
        x = self.conv1(x).flatten(2).transpose(1, 2)               # (B, grid², width)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.ln_post(self.transformer(x)[:, 0])
        return x @ self.proj


class CLIP(nn.Module):
    """OpenAI's CLIP on ``device`` (CUDA unless named), random weights from
    ``generator`` (on the same device) at the JAX package's init scales
    (checkpoints replace them, ``load_openai_clip``)."""

    def __init__(self, cfg: Optional[CLIPConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = cfg or vit_b32()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.no_grad():
            self.visual = VisionTransformer(cfg, device, generator)
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width, device=device)
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding = _normal((cfg.context_length, cfg.text_width), 0.01,
                                                device, generator)
            self.transformer = Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads,
                                           device, generator)
            self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-5, device=device)
            self.text_projection = _normal((cfg.text_width, cfg.embed_dim), 0.02, device,
                                           generator)
            self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07), device=device))
            for m in self.modules():           # Flax's LeCun-normal kernels, zero biases
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
        self.register_buffer("mean", torch.from_numpy(CLIP_MEAN).to(device), persistent=False)
        self.register_buffer("std", torch.from_numpy(CLIP_STD).to(device), persistent=False)
        self.eval()

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images NHWC in [0, 1] at ``image_resolution`` → L2-normalized
        embeddings (B, embed_dim)."""
        x = ((images - self.mean) / self.std).permute(0, 3, 1, 2)
        f = self.visual(x)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L), L ≤ ``context_length``, the EOT token the largest id
        of each row (CLIP's argmax pooling) → L2-normalized (B, embed_dim)."""
        tokens = torch.as_tensor(tokens, device=self.token_embedding.weight.device).long()
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        x = self.ln_final(self.transformer(x, causal=True))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        f = x @ self.text_projection
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        """→ (logits_per_image, logits_per_text), like the OpenAI module."""
        fi, ft = self.encode_image(images), self.encode_text(tokens)
        scale = self.logit_scale.exp()
        return scale * fi @ ft.T, scale * ft @ fi.T


# --------------------------------------------------------------------------
# OpenAI checkpoints


def config_from_state_dict(sd: Dict) -> CLIPConfig:
    """Recover the geometry from an OpenAI CLIP state dict (the probing the
    ``clip`` package's ``build_model`` does); heads are width / 64."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vlayers = len({k.split(".")[3] for k in sd
                   if k.startswith("visual.transformer.resblocks.")})
    tlayers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    return CLIPConfig(
        image_resolution=grid * patch,
        patch_size=patch,
        vision_width=vision_width,
        vision_layers=vlayers,
        vision_heads=vision_width // 64,
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=sd["token_embedding.weight"].shape[1],
        text_layers=tlayers,
        text_heads=sd["token_embedding.weight"].shape[1] // 64,
    )


def load_openai_clip(state_dict: Dict, cfg: Optional[CLIPConfig] = None, device=None
                     ) -> Tuple[CLIP, CLIPConfig]:
    """An OpenAI ``clip`` state dict (tensors or numpy arrays) → ``(CLIP on
    ``device``, config)`` through a strict ``load_state_dict``: the module's
    names are the checkpoint's.  ``cfg`` overrides the probed geometry (head
    counts are not stored; the width/64 rule is used unless given)."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).float()
          for k, v in state_dict.items() if k not in _NON_WEIGHT_KEYS}
    cfg = cfg or config_from_state_dict(sd)
    net = CLIP(cfg, device=device)
    net.load_state_dict(sd)
    return net, cfg


def load_clip_file(path: Optional[str] = None, device=None) -> Tuple[CLIP, CLIPConfig]:
    """A local OpenAI CLIP checkpoint (the torchscript ``.pt`` ``clip.load``
    ships, or a plain state dict) → ``load_openai_clip``.  Env-gated:
    ``$ICGAN_CLIP_WEIGHTS``."""
    path = path or os.environ.get("ICGAN_CLIP_WEIGHTS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "CLIP weights not found: set $ICGAN_CLIP_WEIGHTS to a local ViT-B/32 "
            "checkpoint (the colab downloads it; nothing is downloaded here)")
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except (RuntimeError, ValueError):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return load_openai_clip(sd, device=device)
