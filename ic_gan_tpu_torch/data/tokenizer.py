"""CLIP's byte-pair-encoding tokenizer — pure Python, vocab env-gated.  The
port's copy of ``ic_gan_tpu/data/tokenizer.py``.

The colab's ``clip.tokenize(prompt)`` (``inference/icgan_colab.ipynb``)
wraps OpenAI's SimpleTokenizer: GPT-2-style byte→unicode mapping, BPE merges
from ``bpe_simple_vocab_16e6.txt.gz``, lowercased whitespace-collapsed text,
``<|startoftext|> tokens <|endoftext|>`` padded to the context length.

The merges file ships inside the ``clip`` package (not installable here), so
it is env-gated like every pretrained artifact: ``$ICGAN_CLIP_BPE``. The
algorithm itself is self-contained and tested with synthetic merge tables.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # OpenAI runs ftfy.fix_text; offline we cover its common effect
    # (html unescaping, applied twice like the original).
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """OpenAI CLIP's tokenizer given a merges list.

    ``merges``: list of (a, b) string pairs in priority order — either from
    the real ``bpe_simple_vocab_16e6.txt.gz`` (``from_file``) or synthetic
    (tests). The vocab is built exactly like OpenAI's: 256 byte symbols,
    their ``</w>`` variants, one token per merge, then the two specials.
    """

    # OpenAI's pattern uses \p{L}/\p{N} via the `regex` module; stdlib `re`
    # has no unicode property classes, so letters/digits fall back to the
    # unicode-aware \w split below (identical on the ascii prompts the colab
    # uses; non-ascii letters still group as words via re.UNICODE \w).
    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE | re.UNICODE)

    def __init__(self, merges: List[Tuple[str, str]]):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for a, b in merges:
            vocab.append(a + b)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @classmethod
    def from_file(cls, bpe_path: Optional[str] = None) -> "SimpleTokenizer":
        bpe_path = bpe_path or os.environ.get("ICGAN_CLIP_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "BPE merges file not found — set $ICGAN_CLIP_BPE to a local "
                "bpe_simple_vocab_16e6.txt.gz (ships inside the clip "
                "package; zero egress here).")
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # OpenAI slices [1 : 49152-256-2+1] (drop header, cap vocab at 49408)
        lines = lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(merges)  # type: ignore[arg-type]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in re.findall(self.PAT, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: List[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())


def tokenize(texts, tokenizer: SimpleTokenizer, context_length: int = 77,
             truncate: bool = True) -> np.ndarray:
    """``clip.tokenize`` equivalent: (B, context_length) int32 with
    SOT/EOT framing and zero padding."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [tokenizer.sot] + tokenizer.encode(text) + [tokenizer.eot]
        if len(toks) > context_length:
            if not truncate:
                raise ValueError(f"input too long: {text!r}")
            toks = toks[:context_length - 1] + [tokenizer.eot]
        out[i, :len(toks)] = toks
    return out
