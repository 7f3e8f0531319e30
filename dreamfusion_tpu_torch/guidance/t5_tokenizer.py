"""T5's tokenizer from a local ``tokenizer.json``, in plain Python
(``dreamfusion_tpu/guidance/deepfloyd.py::encode_text``'s
``T5TokenizerFast``, which the GPU host cannot import: it has neither
transformers nor sentencepiece).

The file is the Hugging Face ``tokenizers`` format of a Unigram model, read
as that library runs it:
- the added tokens (``<pad>``, ``</s>``, ``<extra_id_*>``…) are matched in
  the raw text first and keep their ids;
- the normalizer: a ``Sequence`` of ``NFKC``, ``Strip`` and ``Replace``
  (a string or a regex); ``Precompiled`` (sentencepiece's compiled NFKC
  table, T5's) is read as unicodedata's NFKC, which it is for the
  prompts' characters;
- the pre-tokenizer: ``Metaspace`` (spaces to ``▁``, the prefix by
  ``prepend_scheme``, split before each ``▁``) and ``WhitespaceSplit``;
- the model: Viterbi over the pieces' scores, a character no piece covers
  an unknown of score min(score) - 10, adjacent unknowns fused;
- the post-processor's template (``$A </s>``), truncation to ``max_len``
  with the template's tokens kept, padding with ``<pad>`` on the right.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

UNK_PENALTY = 10.0


def _normalize(spec: Optional[dict], text: str) -> str:
    if not spec:
        return text
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["normalizers"]:
            text = _normalize(sub, text)
        return text
    if kind in ("NFKC", "Precompiled"):
        return unicodedata.normalize("NFKC", text)
    if kind == "Strip":
        if spec.get("strip_left", True):
            text = text.lstrip()
        return text.rstrip() if spec.get("strip_right", True) else text
    if kind == "Replace":
        pat = spec["pattern"]
        if "Regex" in pat:
            return re.sub(pat["Regex"], spec["content"], text)
        return text.replace(pat["String"], spec["content"])
    raise ValueError(f"tokenizer.json: normalizer {kind} is not read")


def _pre_tokenize(spec: Optional[dict], words: List[str],
                  first: bool) -> List[str]:
    """Split each of `words`; `first`: the text's first section (for
    Metaspace's ``prepend_scheme`` "first")."""
    if not spec:
        return words
    kind = spec["type"]
    if kind == "Sequence":
        for sub in spec["pretokenizers"]:
            words = _pre_tokenize(sub, words, first)
        return words
    if kind == "WhitespaceSplit":
        return [w for word in words for w in word.split()]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        out = []
        for i, word in enumerate(words):
            if not word:
                continue
            word = word.replace(" ", rep)
            if not word.startswith(rep) and (
                    scheme == "always" or scheme == "first" and first
                    and i == 0):
                word = rep + word
            if spec.get("split", True):
                out += [p for p in re.split(f"(?={re.escape(rep)})", word)
                        if p]
            else:
                out.append(word)
        return out
    raise ValueError(f"tokenizer.json: pre-tokenizer {kind} is not read")


class T5Tokenizer:
    """``tokenizer.json`` → ``(ids, attention_mask)`` [1, max_len] int32,
    as ``T5TokenizerFast(text, padding="max_length", max_length=max_len,
    truncation=True)`` gives them."""

    def __init__(self, path: str, max_len: int):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: a {model.get('type')} model, not "
                             f"Unigram")
        self.pieces: Dict[str, Tuple[int, float]] = {
            p: (i, float(s)) for i, (p, s) in enumerate(model["vocab"])}
        self.unk_id = model.get("unk_id")
        scores = [s for _, s in model["vocab"]]
        self.unk_score = min(scores) - UNK_PENALTY
        self.max_piece = max(len(p) for p in self.pieces)
        self.normalizer = spec.get("normalizer")
        self.pre_tokenizer = spec.get("pre_tokenizer")
        self.added = sorted(((t["content"], t["id"])
                             for t in spec.get("added_tokens", [])),
                            key=lambda t: -len(t[0]))
        self.suffix: List[int] = []
        post = spec.get("post_processor") or {}
        if post.get("type") == "TemplateProcessing":
            special = post.get("special_tokens", {})
            seen = False
            for item in post["single"]:
                if "Sequence" in item:
                    seen = True
                elif seen:
                    self.suffix += special[item["SpecialToken"]["id"]]["ids"]
                else:
                    raise ValueError(f"{path}: tokens before $A are not "
                                     f"read")
        self.pad_id = self.pieces.get("<pad>", (0, 0.0))[0]
        self.max_len = max_len

    def _viterbi(self, word: str) -> List[int]:
        """The word's best segmentation into pieces → their ids, adjacent
        unknowns fused."""
        n = len(word)
        best = [(0.0, -1, None)] + [None] * n   # (score, start, id)
        for i in range(n):
            if best[i] is None:
                continue
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                hit = self.pieces.get(word[i:j])
                if hit is None:
                    continue
                single |= j == i + 1
                s = best[i][0] + hit[1]
                if best[j] is None or s > best[j][0]:
                    best[j] = (s, i, hit[0])
            if not single:
                s = best[i][0] + self.unk_score
                if best[i + 1] is None or s > best[i + 1][0]:
                    best[i + 1] = (s, i, None)
        ids, j = [], n
        while j > 0:
            _, i, tid = best[j]
            if tid is None and ids and ids[-1] is None:
                pass                               # fuse unknowns
            else:
                ids.append(tid)
            j = i
        return [self.unk_id if t is None else t for t in reversed(ids)]

    def encode(self, text: str) -> List[int]:
        """`text` → the model's ids, before the template."""
        sections: List[Tuple[str, Optional[int]]] = [(text, None)]
        for content, tid in self.added:
            out = []
            for s, t in sections:
                if t is not None:
                    out.append((s, t))
                    continue
                parts = s.split(content)
                for k, part in enumerate(parts):
                    if k:
                        out.append((content, tid))
                    if part:
                        out.append((part, None))
            sections = out
        ids: List[int] = []
        for k, (s, t) in enumerate(sections):
            if t is not None:
                ids.append(t)
                continue
            words = _pre_tokenize(self.pre_tokenizer,
                                  [_normalize(self.normalizer, s)], k == 0)
            for w in words:
                ids += self._viterbi(w)
        return ids

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.encode(text)[:self.max_len - len(self.suffix)] + \
            self.suffix
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids = ids + [self.pad_id] * (self.max_len - len(ids))
        return (np.asarray([ids], np.int32), np.asarray([mask], np.int32))
