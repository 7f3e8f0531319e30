"""Prompt keyword decomposition for the R-precision protocol
(``dreamfusion_tpu/evaluation/prompt.py``).

With a local transformers keyword model (``--model_path``, vlt5-style) the
reference's seq2seq keywords; otherwise a dependency-free heuristic: stop
words and articles dropped, the prompt split on punctuation and
conjunctions into content phrases.  Each keyword can be scored as a probe
prompt by ``r_precision``.
"""

from __future__ import annotations

import argparse
import re
from typing import List

_STOP = {
    "a", "an", "the", "of", "in", "on", "at", "is", "are", "with", "and",
    "or", "to", "its", "it", "his", "her", "their", "that", "this", "made",
    "wearing", "sitting", "standing", "front", "next", "by", "very",
    "highly", "detailed", "photo", "dslr", "3d", "render", "rendering",
}


def decompose(text: str, max_keywords: int = 8) -> List[str]:
    """Prompt → keyword phrases (the heuristic)."""
    parts = re.split(r"[,;.]| and | with | on | in front of | next to ",
                     text.lower())
    out: List[str] = []
    for p in parts:
        words = [w for w in re.findall(r"[a-z0-9'-]+", p) if w not in _STOP]
        phrase = " ".join(words)
        if phrase and phrase not in out:
            out.append(phrase)
    return out[:max_keywords]


def decompose_with_model(text: str, model_path: str) -> List[str]:
    """Keywords from a local vlt5-style keyword model."""
    from transformers import AutoModelForSeq2SeqLM, AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(model_path)
    model = AutoModelForSeq2SeqLM.from_pretrained(model_path)
    ids = tokenizer([f"Keywords: {text}"], return_tensors="pt",
                    truncation=True).input_ids
    output = model.generate(ids, no_repeat_ngram_size=3, num_beams=4)
    decoded = tokenizer.decode(output[0], skip_special_tokens=True)
    return [k.strip() for k in decoded.split(",") if k.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser("prompt decomposition")
    ap.add_argument("--text", required=True)
    ap.add_argument("--model_path", default=None,
                    help="local keyword model (optional)")
    args = ap.parse_args(argv)
    kws = decompose_with_model(args.text, args.model_path) \
        if args.model_path else decompose(args.text)
    print("\n".join(kws))
    return kws


if __name__ == "__main__":
    main()
