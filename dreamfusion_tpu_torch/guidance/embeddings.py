"""Prompt embeddings, computed once at start-up
(``dreamfusion_tpu/guidance/embeddings.py``).

No tokenizer files or weights ship with the repository, so the prompt goes
through the hash tokenizer (a copy of the JAX package's): a stable id per
word, as random as the random text tower it feeds.
"""

from __future__ import annotations

import hashlib
from typing import Dict

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


@torch.no_grad()
def prepare_text_embeddings(guidance, text: str, negative: str = ""
                            ) -> Dict[str, torch.Tensor]:
    """→ default / uncond / front / side / back, each [1, L, D] fp32 on the
    text tower's device."""
    enc = guidance.text_encoder
    tok = HashTokenizer(enc.cfg.vocab_size, enc.cfg.max_len)
    dev = enc.embeddings.token_embedding.weight.device

    def embed(s: str) -> torch.Tensor:
        ids = torch.from_numpy(tok(s)).long().to(dev)
        return enc(ids).float()

    out = {"default": embed(text), "uncond": embed(negative)}
    for d, suffix in DIRECTION_SUFFIXES.items():
        out[d] = embed(f"{text}, {suffix}")
    return out
