"""Prompt embeddings, computed once at start-up
(``dreamfusion_tpu/guidance/embeddings.py``).

``load_tokenizer`` follows JAX's rule: CLIP's tokenizer when
``pretrained_root`` holds its files (``vocab.json`` and ``merges.txt``),
else the hash tokenizer (a copy of the JAX package's: a stable id per word,
as random as the random text tower it feeds).  JAX loads
``transformers.CLIPTokenizer``; the GPU host has no transformers, so
``CLIPBPETokenizer`` is that tokenizer's byte-level BPE in plain Python, as
transformers runs it without ftfy: the text cleaned, NFC-normalised and
lower-cased, split by CLIP's pre-tokenizer pattern, each piece's UTF-8
bytes mapped to printable characters, merged by rank with ``</w>`` ending
a word, framed by BOS and EOS, and truncated or padded (with EOS) to
``max_len``.  No tokenizer files ship with the repository.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DIRECTION_SUFFIXES = {"front": "front view", "side": "side view",
                      "back": "back view"}


class HashTokenizer:
    """Deterministic stand-in tokenizer: word → stable id (md5)."""

    def __init__(self, vocab_size: int, max_len: int, bos: int = 0,
                 eos: int = 1):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.bos, self.eos = bos, eos

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.bos]
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(2 + h % (self.vocab_size - 2))
        ids = ids[: self.max_len - 1] + [self.eos]
        ids = ids + [self.eos] * (self.max_len - len(ids))
        return np.asarray([ids], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible byte → printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def clean_text(text: str) -> str:
    """transformers' ``BasicTokenizer`` (no accent stripping, no split on
    punctuation): control characters dropped, whitespace made spaces, CJK
    characters spaced apart, NFC, lower case, one space between words."""
    out = []
    for c in text:
        cp = ord(c)
        if c in "\t\n\r" or unicodedata.category(c) == "Zs":
            out.append(" ")
        elif cp in (0, 0xFFFD) or unicodedata.category(c).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {c} ")
        else:
            out.append(c)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pre_tokenize(text: str) -> List[str]:
    """CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|
    'd|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-insensitive) as
    ``re.findall`` applies it: at each place the first alternative that
    matches; whitespace matches none."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        head = next((w for w in _SPECIALS + _CONTRACTIONS
                     if text[i:i + len(w)].lower() == w), None)
        if head is not None:
            j = i + len(head)
        elif _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            j = i + 1
        elif c.isspace():
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPBPETokenizer:
    """CLIP's byte-level BPE from ``vocab.json`` and ``merges.txt``; called
    as the hash tokenizer is: text → int32 ids [1, max_len]."""

    def __init__(self, vocab_file: str, merges_file: str, max_len: int):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.max_len = max_len
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.byte_map = bytes_to_unicode()
        self.cache: Dict[str, Tuple[str, ...]] = {w: (w,) for w in _SPECIALS}

    def bpe(self, token: str) -> Tuple[str, ...]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = word
        return word

    def tokens(self, text: str) -> List[int]:
        """The ids of `text`, without BOS, EOS or padding."""
        unk = self.encoder.get("<|endoftext|>")
        ids = []
        for piece in pre_tokenize(clean_text(text)):
            mapped = "".join(self.byte_map[b] for b in piece.encode("utf-8"))
            ids += [self.encoder.get(t, unk) for t in self.bpe(mapped)]
        return ids

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.bos] + self.tokens(text)[:self.max_len - 2] + [self.eos]
        ids += [self.eos] * (self.max_len - len(ids))
        return np.asarray([ids], dtype=np.int32)


def load_tokenizer(pretrained_root: Optional[str], vocab_size: int,
                   max_len: int):
    """CLIP's BPE tokenizer when `pretrained_root` holds ``vocab.json`` and
    ``merges.txt``, else the hash tokenizer (JAX's rule)."""
    if pretrained_root:
        files = [os.path.join(pretrained_root, f)
                 for f in ("vocab.json", "merges.txt")]
        if all(os.path.isfile(f) for f in files):
            return CLIPBPETokenizer(*files, max_len)
    return HashTokenizer(vocab_size, max_len)


@torch.no_grad()
def prepare_text_embeddings(guidance, text: str, negative: str = "",
                            pretrained_root: Optional[str] = None
                            ) -> Dict[str, torch.Tensor]:
    """→ default / uncond / front / side / back, each [1, L, D] fp32 on the
    text tower's device."""
    enc = guidance.text_encoder
    tok = load_tokenizer(pretrained_root, enc.cfg.vocab_size,
                         enc.cfg.max_len)
    dev = enc.embeddings.token_embedding.weight.device

    def embed(s: str) -> torch.Tensor:
        ids = torch.from_numpy(tok(s)).long().to(dev)
        return enc(ids).float()

    out = {"default": embed(text), "uncond": embed(negative)}
    for d, suffix in DIRECTION_SUFFIXES.items():
        out[d] = embed(f"{text}, {suffix}")
    return out
